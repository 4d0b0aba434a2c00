"""Covariance functions for Gaussian-process regression.

JAX rebuild of the reference kernel classes
(reference: inference/gp/covariance.py:8-705) with the same public API
(``pass_spatial_data``, ``estimate_hyperpar_bounds``, ``__call__``,
``build_covariance``, ``covariance_and_gradients``, composition via ``+``),
but different internals:

- **No N x N x D precomputed distance tensor** (the reference's memory wall,
  reference: covariance.py:218-219). Pairwise scaled squared distances are
  assembled on the fly (``ops.pairwise``) at O(N^2) memory rather than
  O(N^2 D).
- **Hyperparameter gradients via autodiff**: ``covariance_and_gradients``
  is ``jax.jacfwd`` of ``build_covariance`` (the reference hand-derives each
  kernel's gradients, reference: covariance.py:268-276,350-365,561-593).
  The main fitting path in ``GpRegressor`` differentiates the scalar
  marginal-likelihood directly and never materialises per-parameter dK
  matrices at all.
"""

from abc import ABC, abstractmethod
from collections.abc import Sequence
from inspect import isclass
from itertools import chain

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.pairwise import scaled_sq_distances, sqexp_covariance
from ..ops.linalg import add_diagonal


class CovarianceFunction(ABC):
    """Abstract base class for covariance functions."""

    @abstractmethod
    def pass_spatial_data(self, x):
        pass

    @abstractmethod
    def estimate_hyperpar_bounds(self, y):
        pass

    @abstractmethod
    def __call__(self, u, v, theta):
        pass

    @abstractmethod
    def build_covariance(self, theta):
        pass

    def matrix(self, x, theta):
        """Data covariance built from an explicitly-passed (traceable) data
        array rather than the stored spatial data. Compiled programs that
        use ``matrix`` can take the data as a runtime argument, so refitting
        on new data of the same (padded) shape reuses the compilation."""
        return self(x, x, theta)

    def covariance_and_gradients(self, theta):
        """
        The data covariance matrix and its gradients with respect to each
        hyperparameter, computed by forward-mode autodiff (the fitting path
        never needs this method — it differentiates the scalar likelihood
        in reverse mode).
        """
        theta = jnp.asarray(theta)
        K = self.build_covariance(theta)
        jac = jax.jacfwd(self.build_covariance)(theta)
        return K, [jac[..., i] for i in range(theta.size)]

    def __add__(self, other):
        K1 = self.components if isinstance(self, CompositeCovariance) else [self]
        K2 = other.components if isinstance(other, CompositeCovariance) else [other]
        return CompositeCovariance([*K1, *K2])

    def gradient_terms(self, v, x, theta):
        raise NotImplementedError(
            f"Gradient calculations are not yet available for the "
            f"{type(self)} covariance function."
        )


class CompositeCovariance(CovarianceFunction):
    """Sum of covariance components with per-component hyperparameter slices
    (reference: covariance.py:47-105)."""

    def __init__(self, covariance_components):
        self.components = covariance_components
        self.bounds = None

    def pass_spatial_data(self, x):
        for comp in self.components:
            comp.pass_spatial_data(x)
        self.slices = slice_builder([c.n_params for c in self.components])
        self.hyperpar_labels = []
        for i, comp in enumerate(self.components):
            self.hyperpar_labels.extend(
                f"K{i + 1}: {s}" for s in comp.hyperpar_labels
            )
        self.n_params = sum(c.n_params for c in self.components)
        assert self.n_params == len(self.hyperpar_labels)

    def estimate_hyperpar_bounds(self, y):
        for comp in self.components:
            if comp.bounds is None:
                comp.estimate_hyperpar_bounds(y)
        self.bounds = []
        for comp in self.components:
            self.bounds.extend(comp.bounds)
        assert self.n_params == len(self.bounds)

    def __call__(self, u, v, theta):
        theta = jnp.asarray(theta)
        return sum(
            comp(u, v, theta[slc]) for comp, slc in zip(self.components, self.slices)
        )

    def build_covariance(self, theta):
        theta = jnp.asarray(theta)
        return sum(
            comp.build_covariance(theta[slc])
            for comp, slc in zip(self.components, self.slices)
        )

    def matrix(self, x, theta):
        theta = jnp.asarray(theta)
        return sum(
            comp.matrix(x, theta[slc])
            for comp, slc in zip(self.components, self.slices)
        )


class WhiteNoise(CovarianceFunction):
    r"""
    Independent identically-distributed Gaussian noise:
    ``K(x_i, x_j) = delta_ij * sigma_n^2`` with hyperparameter
    ``ln(sigma_n)`` (reference: covariance.py:108-178). Use as part of a
    composite kernel, e.g. ``SquaredExponential() + WhiteNoise()``.
    """

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds
        self.n_params = 1
        self.hyperpar_labels = ["WhiteNoise log-sigma"]

    def pass_spatial_data(self, x):
        self.n_data = int(x.shape[0])

    def estimate_hyperpar_bounds(self, y):
        # host statistics: per-data-shape jnp calls would recompile on
        # every update_data refit of a growing data set
        s = float(np.log(np.ptp(np.asarray(y))))
        self.bounds = [(s - 8, s + 2)]

    def __call__(self, u, v, theta):
        return jnp.zeros([u.shape[0], v.shape[0]])

    def build_covariance(self, theta):
        theta = jnp.asarray(theta)
        # diag of a traced vector (never an N x N identity constant)
        return jnp.diag(jnp.full(self.n_data, jnp.exp(2 * theta[0])))

    def matrix(self, x, theta):
        theta = jnp.asarray(theta)
        return jnp.diag(jnp.full(x.shape[0], jnp.exp(2 * theta[0])))

    def get_bounds(self):
        return self.bounds


class SquaredExponential(CovarianceFunction):
    r"""
    Squared-exponential kernel
    ``K(u, v) = A^2 exp(-0.5 sum_i ((u_i - v_i)/l_i)^2)`` with
    hyperparameters ``[ln A, ln l_1, ..., ln l_n]``
    (reference: covariance.py:181-279).
    """

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds

    def pass_spatial_data(self, x):
        self.x = jnp.asarray(x)
        n, d = self.x.shape
        self.n_params = d + 1
        self.hyperpar_labels = ["SqrExp log-amplitude"]
        self.hyperpar_labels.extend(f"SqrExp log-scale {i}" for i in range(d))

    def estimate_hyperpar_bounds(self, y):
        # host statistics (avoids per-data-shape recompiles on refits)
        s = float(np.log(np.asarray(y).std()))
        self.bounds = [(s - 4, s + 4)]
        # distance statistics from a subsample (the reference computes the
        # full N x N x D tensor here; a subsample gives the same bounds
        # scale without the memory cost)
        x = np.asarray(self.x)
        if x.shape[0] > 2000:
            idx = np.random.default_rng(0).choice(x.shape[0], 2000, replace=False)
            x = x[idx]
        dx = x[:, None, :] - x[None, :, :]
        for i in range(x.shape[1]):
            lwr = float(np.log(np.abs(dx[:, :, i]).mean())) - 4
            upr = float(np.log(dx[:, :, i].max())) + 2
            self.bounds.append((lwr, upr))

    def __call__(self, u, v, theta):
        theta = jnp.asarray(theta)
        a = jnp.exp(theta[0])
        L = jnp.exp(theta[1:])
        return sqexp_covariance(jnp.asarray(u), jnp.asarray(v), a, L)

    def build_covariance(self, theta):
        return self.matrix(self.x, theta)

    def matrix(self, x, theta):
        theta = jnp.asarray(theta)
        a = jnp.exp(theta[0])
        L = jnp.exp(theta[1:])
        K = sqexp_covariance(jnp.asarray(x), jnp.asarray(x), a, L)
        # diagonal jitter scaled by the amplitude (reference: covariance.py:221)
        return add_diagonal(K, a**2 * 1e-12)

    def gradient_terms(self, v, x, theta):
        """Kernel-specific terms for predictive-gradient calculations
        (reference: covariance.py:257-266)."""
        theta = jnp.asarray(theta)
        a = jnp.exp(theta[0])
        L = jnp.exp(theta[1:])
        A = (jnp.asarray(x) - jnp.asarray(v)[None, :]) / L[None, :] ** 2
        return A.T, jnp.diag((a / L) ** 2)

    def get_bounds(self):
        return self.bounds


class RationalQuadratic(CovarianceFunction):
    r"""
    Rational-quadratic kernel
    ``K(u, v) = A^2 (1 + Z/alpha)^(-alpha)`` with
    ``Z = 0.5 sum_i ((u_i - v_i)/l_i)^2`` and hyperparameters
    ``[ln A, ln alpha, ln l_1, ..., ln l_n]``
    (reference: covariance.py:282-368).
    """

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds

    def pass_spatial_data(self, x):
        self.x = jnp.asarray(x)
        n, d = self.x.shape
        self.n_params = d + 2
        self.hyperpar_labels = ["RQ log-amplitude", "RQ log-alpha"]
        self.hyperpar_labels.extend(f"RQ log-scale {i}" for i in range(d))

    def estimate_hyperpar_bounds(self, y):
        s = float(np.log(np.asarray(y).std()))
        self.bounds = [(s - 4, s + 4), (-2, 6)]
        x = np.asarray(self.x)
        if x.shape[0] > 2000:
            idx = np.random.default_rng(0).choice(x.shape[0], 2000, replace=False)
            x = x[idx]
        dx = x[:, None, :] - x[None, :, :]
        for i in range(x.shape[1]):
            lwr = float(np.log(np.abs(dx[:, :, i]).mean())) - 4
            upr = float(np.log(dx[:, :, i].max())) + 2
            self.bounds.append((lwr, upr))

    def __call__(self, u, v, theta):
        theta = jnp.asarray(theta)
        a = jnp.exp(theta[0])
        k = jnp.exp(theta[1])
        L = jnp.exp(theta[2:])
        Z = 0.5 * scaled_sq_distances(jnp.asarray(u), jnp.asarray(v), L)
        return (a**2) * (1 + Z / k) ** (-k)

    def build_covariance(self, theta):
        return self.matrix(self.x, theta)

    def matrix(self, x, theta):
        theta = jnp.asarray(theta)
        a = jnp.exp(theta[0])
        k = jnp.exp(theta[1])
        L = jnp.exp(theta[2:])
        x = jnp.asarray(x)
        Z = 0.5 * scaled_sq_distances(x, x, L)
        return add_diagonal((a**2) * (1 + Z / k) ** (-k), a**2 * 1e-12)

    def get_bounds(self):
        return self.bounds


class HeteroscedasticNoise(CovarianceFunction):
    r"""
    Heteroscedastic (per-data-point) Gaussian noise:
    ``K(x_i, x_j) = delta_ij * sigma_i^2`` with one ``ln sigma_i``
    hyperparameter per data value (reference: covariance.py:608-689).

    The reference precomputes n_data one-hot gradient matrices — O(N^3)
    memory; here the fitting path differentiates the scalar likelihood
    directly, so no per-parameter matrices are ever built.
    """

    def __init__(self, hyperpar_bounds=None):
        self.bounds = hyperpar_bounds

    def pass_spatial_data(self, x):
        self.n_params = int(x.shape[0])
        self.hyperpar_labels = [f"log_sigma_{i + 1}" for i in range(self.n_params)]

    def estimate_hyperpar_bounds(self, y):
        s = float(np.log(np.ptp(np.asarray(y))))
        self.bounds = [(s - 8, s + 2) for _ in range(self.n_params)]

    def __call__(self, u, v, theta):
        return jnp.zeros([u.shape[0], v.shape[0]])

    def build_covariance(self, theta):
        return jnp.diag(jnp.exp(2 * jnp.asarray(theta)))

    def matrix(self, x, theta):
        return self.build_covariance(theta)

    def covariance_and_gradients(self, theta):
        """Structured gradients: dK/dtheta_i = 2 sigma_i^2 e_i e_i^T,
        returned as a LAZY sequence — each matrix is built on access, so
        iterating costs one (n, n) buffer at a time instead of the
        reference's n-matrix O(n^3) precomputed stack
        (reference: covariance.py:655-659)."""
        theta = jnp.asarray(theta)
        sigma_sq = jnp.exp(2 * theta)
        K = jnp.diag(sigma_sq)
        n = self.n_params

        class _LazyDiagGrads(Sequence):
            def __len__(self):
                return n

            def __getitem__(self, i):
                if not 0 <= i < n:
                    raise IndexError(i)
                return 2.0 * sigma_sq[i] * jnp.zeros((n, n)).at[i, i].set(1.0)

        return K, _LazyDiagGrads()

    def get_bounds(self):
        return self.bounds


class ChangePoint(CovarianceFunction):
    r"""
    Change-point kernel: divides the input space into regions along a chosen
    axis, each modelled by its own kernel, blended by logistic weighting
    functions whose locations and widths are hyperparameters
    (reference: covariance.py:371-605).

    :param kernels: tuple of kernel objects/classes ``(K1, K2, ...)``.
    :param axis: the spatial axis over which transitions occur.
    :param location_bounds: optional bounds for the change-point locations.
    :param width_bounds: optional bounds for the change-point widths.
    """

    def __init__(
        self,
        kernels: Sequence,
        axis: int = 0,
        location_bounds: Sequence = None,
        width_bounds: Sequence = None,
    ):
        self.cov = [
            K() if isclass(K) and issubclass(K, CovarianceFunction) else K
            for K in kernels
        ]
        for K in self.cov:
            if not isinstance(K, CovarianceFunction):
                raise TypeError(
                    "[ ChangePoint error ] Each of the specified covariance "
                    "kernels must be an instance of a class inheriting from "
                    "the 'CovarianceFunction' abstract base-class."
                )

        self.n_kernels = len(kernels)

        if location_bounds is not None:
            if len(location_bounds) != self.n_kernels - 1:
                raise ValueError(
                    "[ ChangePoint error ] The length of 'location_bounds' "
                    "must be one less than the number of kernels"
                )
            self.location_bounds = [check_bounds(b) for b in location_bounds]
        else:
            self.location_bounds = None

        if width_bounds is not None:
            if len(width_bounds) != self.n_kernels - 1:
                raise ValueError(
                    "[ ChangePoint error ] The length of 'width_bounds' "
                    "must be one less than the number of kernels"
                )
            self.width_bounds = [check_bounds(b) for b in width_bounds]
        else:
            self.width_bounds = None

        self.axis = axis
        self.bounds = None

    def pass_spatial_data(self, x):
        x = jnp.asarray(x)
        for K in self.cov:
            K.pass_spatial_data(x)
        param_counts = [K.n_params for K in self.cov]
        param_counts.extend([2] * (self.n_kernels - 1))
        self.n_params = sum(param_counts)
        slices = slice_builder(param_counts)
        self.cov_slc = slices[: self.n_kernels]
        self.cp_slc = slices[self.n_kernels :]

        labels = []
        for i, K in enumerate(self.cov):
            labels.extend(f"ChngPnt K{i}: {lab}" for lab in K.hyperpar_labels)
        for i in range(self.n_kernels - 1):
            labels.extend([f"ChngPnt{i} location", f"ChngPnt{i} width"])
        self.hyperpar_labels = labels

        self.x_cp = np.asarray(x)[:, self.axis]
        assert self.n_params == len(self.hyperpar_labels)

    def estimate_hyperpar_bounds(self, y):
        xr = (float(self.x_cp.min()), float(self.x_cp.max()))
        dx = xr[1] - xr[0]
        self.bounds = []
        for cov in self.cov:
            if cov.bounds is None:
                cov.estimate_hyperpar_bounds(y)
            self.bounds.extend(cov.bounds)

        if self.location_bounds is None:
            self.location_bounds = [xr] * (self.n_kernels - 1)
        if self.width_bounds is None:
            self.width_bounds = [(5e-3 * dx, 0.5 * dx)] * (self.n_kernels - 1)

        cp_bounds = chain.from_iterable(zip(self.location_bounds, self.width_bounds))
        self.bounds.extend(cp_bounds)
        assert self.n_params == len(self.bounds)

    @staticmethod
    def logistic(x, theta):
        z = (x - theta[0]) / theta[1]
        return 1.0 / (1.0 + jnp.exp(-z))

    def _kernel_coefficients(self, w_list):
        """Blending weights from per-change-point logistic values."""
        coeffs = [jnp.asarray(1.0)]
        for w_u, w_v in w_list:
            w1 = (1 - w_u)[:, None] * (1 - w_v)[None, :]
            w2 = w_u[:, None] * w_v[None, :]
            coeffs[-1] = coeffs[-1] * w1
            coeffs.append(w2)
        return coeffs

    def __call__(self, u, v, theta):
        theta = jnp.asarray(theta)
        u, v = jnp.asarray(u), jnp.asarray(v)
        w_list = [
            (
                self.logistic(u[:, self.axis], theta[slc]),
                self.logistic(v[:, self.axis], theta[slc]),
            )
            for slc in self.cp_slc
        ]
        coeffs = self._kernel_coefficients(w_list)
        return sum(
            self.cov[i](u, v, theta[self.cov_slc[i]]) * coeffs[i]
            for i in range(self.n_kernels)
        )

    def build_covariance(self, theta):
        theta = jnp.asarray(theta)
        w_list = [
            (self.logistic(self.x_cp, theta[slc]),) * 2 for slc in self.cp_slc
        ]
        coeffs = self._kernel_coefficients(w_list)
        return sum(
            self.cov[i].build_covariance(theta[self.cov_slc[i]]) * coeffs[i]
            for i in range(self.n_kernels)
        )

    def matrix(self, x, theta):
        theta = jnp.asarray(theta)
        x = jnp.asarray(x)
        x_cp = x[:, self.axis]
        w_list = [(self.logistic(x_cp, theta[slc]),) * 2 for slc in self.cp_slc]
        coeffs = self._kernel_coefficients(w_list)
        return sum(
            self.cov[i].matrix(x, theta[self.cov_slc[i]]) * coeffs[i]
            for i in range(self.n_kernels)
        )

    def get_bounds(self):
        return self.bounds


def slice_builder(lengths) -> list:
    slices = [slice(0, lengths[0])]
    for L in lengths[1:]:
        last = slices[-1].stop
        slices.append(slice(last, last + L))
    return slices


def check_bounds(bounds):
    if bounds is not None:
        assert type(bounds) in [list, tuple, np.ndarray]
        assert len(bounds) == 2
        assert bounds[1] > bounds[0]
    return bounds
