"""Mean functions for Gaussian-process regression.

JAX rebuild of the reference mean classes
(reference: inference/gp/mean.py:5-126) with the same API
(``pass_spatial_data``, ``estimate_hyperpar_bounds``, ``__call__``,
``build_mean``, ``mean_and_gradients``), implemented in jax.
"""

from abc import ABC, abstractmethod

import jax
import numpy as np
import jax.numpy as jnp


class MeanFunction(ABC):
    """Abstract base class for mean functions."""

    @abstractmethod
    def pass_spatial_data(self, x):
        pass

    @abstractmethod
    def estimate_hyperpar_bounds(self, y):
        pass

    @abstractmethod
    def __call__(self, q, theta):
        pass

    @abstractmethod
    def build_mean(self, theta):
        pass

    def vector(self, x, theta):
        """Mean vector at explicitly-passed (traceable) data rows.
        Compiled programs that use ``vector``/``point`` can take the data as
        a runtime argument, so refits of the same padded shape reuse their
        compilation. The default falls back to the stored-data methods
        (correct, but bakes the stored arrays into the compilation)."""
        import jax

        return jax.vmap(lambda q: self(q, theta))(x)

    def point(self, q, theta, x):
        """Mean at a single query point; ``x`` provides the data context
        (e.g. the centroid for centred means)."""
        return self(q, theta)

    def mean_and_gradients(self, theta):
        """Mean vector and per-hyperparameter gradients via autodiff."""
        theta = jnp.asarray(theta)
        mu = self.build_mean(theta)
        jac = jax.jacfwd(self.build_mean)(theta)
        return mu, [jac[:, i] for i in range(theta.size)]


class ConstantMean(MeanFunction):
    """Constant mean with one hyperparameter (reference: mean.py:31-51)."""

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds
        self.n_params = 1
        self.hyperpar_labels = ["ConstantMean"]

    def pass_spatial_data(self, x):
        self.n_data = int(x.shape[0])

    def estimate_hyperpar_bounds(self, y):
        # host statistics (avoids per-data-shape recompiles on refits)
        y = np.asarray(y)
        w = float(y.max() - y.min())
        self.bounds = [(float(y.min()) - w, float(y.max()) + w)]

    def __call__(self, q, theta):
        return jnp.asarray(theta)[0]

    def build_mean(self, theta):
        return jnp.full(self.n_data, jnp.asarray(theta)[0])

    def vector(self, x, theta):
        return jnp.full(x.shape[0], jnp.asarray(theta)[0])

    def point(self, q, theta, x):
        return jnp.asarray(theta)[0]


class LinearMean(MeanFunction):
    """Linear mean over centred coordinates (reference: mean.py:54-83)."""

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds

    def pass_spatial_data(self, x):
        # host statistics: per-data-shape jnp calls here would recompile
        # on every update_data refit of a growing data set
        x = np.asarray(x)
        self.x_mean = x.mean(axis=0)
        self.dx = x - self.x_mean[None, :]
        self.n_data = int(x.shape[0])
        self.n_params = 1 + int(x.shape[1])
        self.hyperpar_labels = ["LinearMean background"]
        self.hyperpar_labels.extend(
            f"LinearMean gradient {i}" for i in range(x.shape[1])
        )

    def estimate_hyperpar_bounds(self, y):
        y = np.asarray(y)
        w = float(y.max() - y.min())
        grad_bounds = np.asarray(
            10 * w / (self.dx.max(axis=0) - self.dx.min(axis=0))
        )
        self.bounds = [(float(y.min()) - 2 * w, float(y.max()) + 2 * w)]
        self.bounds.extend((-float(b), float(b)) for b in grad_bounds)

    def __call__(self, q, theta):
        theta = jnp.asarray(theta)
        return theta[0] + jnp.dot(jnp.asarray(q) - self.x_mean, theta[1:]).squeeze()

    def build_mean(self, theta):
        theta = jnp.asarray(theta)
        return theta[0] + self.dx @ theta[1:]

    def vector(self, x, theta):
        # padded rows sit exactly at the real-data centroid, so the mean
        # over the padded array IS the real centroid — vector/point stay
        # exact under shape padding
        theta = jnp.asarray(theta)
        xm = x.mean(axis=0)
        return theta[0] + (x - xm[None, :]) @ theta[1:]

    def point(self, q, theta, x):
        theta = jnp.asarray(theta)
        return theta[0] + jnp.dot(
            jnp.asarray(q) - x.mean(axis=0), theta[1:]
        ).squeeze()


class QuadraticMean(MeanFunction):
    """Quadratic mean without cross terms (reference: mean.py:86-126)."""

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds

    def pass_spatial_data(self, x):
        x = np.asarray(x)
        n = int(x.shape[1])
        self.x_mean = x.mean(axis=0)
        self.dx = x - self.x_mean[None, :]
        self.dx_sqr = self.dx**2
        self.n_data = int(x.shape[0])
        self.n_params = 1 + 2 * n
        self.hyperpar_labels = ["mean_background"]
        self.hyperpar_labels.extend(f"mean_linear_coeff_{i}" for i in range(n))
        self.hyperpar_labels.extend(f"mean_quadratic_coeff_{i}" for i in range(n))
        self.lin_slc = slice(1, n + 1)
        self.quad_slc = slice(n + 1, 2 * n + 1)

    def estimate_hyperpar_bounds(self, y):
        y = np.asarray(y)
        w = float(y.max() - y.min())
        grad_bounds = np.asarray(
            10 * w / (self.dx.max(axis=0) - self.dx.min(axis=0))
        )
        self.bounds = [(float(y.min()) - 2 * w, float(y.max()) + 2 * w)]
        self.bounds.extend((-float(b), float(b)) for b in grad_bounds)
        self.bounds.extend((-float(b), float(b)) for b in grad_bounds)

    def __call__(self, q, theta):
        theta = jnp.asarray(theta)
        d = jnp.asarray(q) - self.x_mean
        lin_term = jnp.dot(d, theta[self.lin_slc]).squeeze()
        quad_term = jnp.dot(d**2, theta[self.quad_slc]).squeeze()
        return theta[0] + lin_term + quad_term

    def build_mean(self, theta):
        theta = jnp.asarray(theta)
        return theta[0] + self.dx @ theta[self.lin_slc] + self.dx_sqr @ theta[self.quad_slc]

    def vector(self, x, theta):
        theta = jnp.asarray(theta)
        d = x - x.mean(axis=0)[None, :]
        return theta[0] + d @ theta[self.lin_slc] + d**2 @ theta[self.quad_slc]

    def point(self, q, theta, x):
        theta = jnp.asarray(theta)
        d = jnp.asarray(q) - x.mean(axis=0)
        lin_term = jnp.dot(d, theta[self.lin_slc]).squeeze()
        quad_term = jnp.dot(d**2, theta[self.quad_slc]).squeeze()
        return theta[0] + lin_term + quad_term
