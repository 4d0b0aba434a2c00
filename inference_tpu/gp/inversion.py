"""Gaussian-process linear inversion.

JAX rebuild of the reference ``GpLinearInverter``
(reference: inference/gp/inversion.py:11-249): linear-Gaussian inverse
problems (tomography / deconvolution) with a GP prior over the model
parameters. The posterior algebra runs as jitted device programs, and the
marginal-likelihood gradient comes from ``jax.value_and_grad`` instead of
the reference's hand-derived trace identities
(reference: inversion.py:190-217).
"""

from inspect import isclass

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular
from scipy.optimize import minimize

from .covariance import CovarianceFunction, SquaredExponential
from ..ops.linalg import identity_like, add_diagonal
from .mean import MeanFunction, ConstantMean


class GpLinearInverter:
    """
    Bayesian solution of linear inverse problems with a Gaussian-process
    prior over the model parameters.

    :param y: data values as a 1D array.
    :param y_err: data standard deviations as a 1D array.
    :param model_matrix: linear forward model as a 2D array.
    :param parameter_spatial_positions: 2D array of the model parameters'
        positions in the space over which their values are correlated.
    :param prior_covariance_function: covariance class or instance for the
        prior (default SquaredExponential).
    :param prior_mean_function: mean class or instance for the prior
        (default ConstantMean).
    """

    def __init__(
        self,
        y,
        y_err,
        model_matrix,
        parameter_spatial_positions,
        prior_covariance_function: CovarianceFunction = SquaredExponential,
        prior_mean_function: MeanFunction = ConstantMean,
    ):
        y = np.asarray(y)
        y_err = np.asarray(y_err)
        model_matrix = np.asarray(model_matrix)

        if model_matrix.ndim != 2:
            raise ValueError(
                "[ GpLinearInverter error ] 'model_matrix' argument must be "
                "a 2D numpy.ndarray"
            )
        if y.ndim != 1 or y_err.ndim != 1 or y.size != y_err.size:
            raise ValueError(
                "[ GpLinearInverter error ] 'y' and 'y_err' arguments must be "
                "1D numpy.ndarray of equal size."
            )
        if model_matrix.shape[0] != y.size:
            raise ValueError(
                f"[ GpLinearInverter error ] The size of the first dimension "
                f"of 'model_matrix' must equal the size of 'y', however they "
                f"have shapes {model_matrix.shape}, {y.shape} respectively."
            )
        if parameter_spatial_positions.ndim != 2:
            raise ValueError(
                "[ GpLinearInverter error ] 'parameter_spatial_positions' "
                "must be a 2D numpy.ndarray with first dimension equal to the "
                "number of model parameters."
            )
        if model_matrix.shape[1] != parameter_spatial_positions.shape[0]:
            raise ValueError(
                f"[ GpLinearInverter error ] The size of the second dimension "
                f"of 'model_matrix' must equal the size of the first dimension "
                f"of 'parameter_spatial_positions', however they have shapes "
                f"{model_matrix.shape}, {parameter_spatial_positions.shape} "
                f"respectively."
            )

        self.A = jnp.asarray(model_matrix)
        self.y = jnp.asarray(y)

        self.cov = prior_covariance_function
        self.cov = self.cov() if isclass(self.cov) else self.cov
        self.cov.pass_spatial_data(jnp.asarray(parameter_spatial_positions))
        if self.cov.bounds is None:
            self.cov.bounds = [(None, None)] * self.cov.n_params

        self.mean = prior_mean_function
        self.mean = self.mean() if isclass(self.mean) else self.mean
        self.mean.pass_spatial_data(jnp.asarray(parameter_spatial_positions))
        if self.mean.bounds is None:
            self.mean.bounds = [(None, None)] * self.mean.n_params

        self.n_hyperpars = self.mean.n_params + self.cov.n_params
        self.mean_slice = slice(0, self.mean.n_params)
        self.cov_slice = slice(self.mean.n_params, self.n_hyperpars)
        self.hyperpar_labels = [*self.mean.hyperpar_labels, *self.cov.hyperpar_labels]

        # dense forms kept as attributes for API parity; the compiled
        # functions use the diagonal vectors (dense N x N constants captured
        # in closures would bloat the compile payload at large N)
        self.sigma = jnp.diag(jnp.asarray(y_err) ** 2)
        self.inv_sigma = jnp.diag(jnp.asarray(y_err) ** -2.0)
        self.I = jnp.eye(self.A.shape[1])
        self._sigma_diag = jnp.asarray(y_err) ** 2
        self._build_compiled()

    def _build_compiled(self):
        """The model matrix, data and noise are RUNTIME arguments of every
        compiled program — captured (N, M) constants would be baked into
        the HLO payload (the compile-size trap regression.py documents)."""
        cov, mean = self.cov, self.mean
        mean_slc, cov_slc = self.mean_slice, self.cov_slice

        def posterior(theta, A, y, sigma_diag):
            inv_sigma_diag = 1.0 / sigma_diag
            K = cov.build_covariance(theta[cov_slc])
            prior_mean = mean.build_mean(theta[mean_slc])
            W = A.T @ (inv_sigma_diag[:, None] * A)
            u = A.T @ (inv_sigma_diag * (y - A @ prior_mean))
            posterior_cov = jnp.linalg.solve(add_diagonal(K @ W, 1.0), K)
            posterior_mean = posterior_cov @ u + prior_mean
            return posterior_mean, posterior_cov

        def lml(theta, A, y, sigma_diag):
            K = cov.build_covariance(theta[cov_slc])
            prior_mean = mean.build_mean(theta[mean_slc])
            J = add_diagonal(A @ K @ A.T, sigma_diag)
            L = jnp.linalg.cholesky(J)
            ok = jnp.isfinite(L).all()
            L_safe = jnp.where(ok, L, identity_like(L))
            v = solve_triangular(L_safe, y - A @ prior_mean, lower=True)
            value = -0.5 * (v @ v) - jnp.log(jnp.diagonal(L_safe)).sum()
            # likelihood floor for failed factorisations; kept inside
            # the dtype's finite range (-1e50 overflows float32)
            floor = jnp.asarray(jnp.finfo(K.dtype).min / 4, K.dtype)
            return jnp.where(ok, value, floor)

        post_jit = jax.jit(posterior)
        lml_jit = jax.jit(lml)
        grad_jit = jax.jit(jax.value_and_grad(lml))
        data = lambda: (self.A, self.y, self._sigma_diag)
        self._posterior = lambda theta: post_jit(theta, *data())
        self._lml = lambda theta: lml_jit(theta, *data())
        self._lml_grad = lambda theta: grad_jit(theta, *data())

    def calculate_posterior(self, theta):
        """Posterior mean and covariance for the given hyperparameters."""
        mu, cov = self._posterior(jnp.asarray(theta))
        return np.asarray(mu), np.asarray(cov)

    def calculate_posterior_mean(self, theta):
        """Posterior mean for the given hyperparameters."""
        mu, _ = self._posterior(jnp.asarray(theta))
        return np.asarray(mu)

    def marginal_likelihood(self, theta) -> float:
        """Log-marginal likelihood in data space."""
        return float(self._lml(jnp.asarray(theta)))

    def marginal_likelihood_gradient(self, theta):
        """LML and its hyperparameter gradient via autodiff."""
        value, grad = self._lml_grad(jnp.asarray(theta))
        return float(value), np.asarray(grad)

    def optimize_hyperparameters(self, initial_guess):
        """
        Maximise the marginal likelihood by Nelder-Mead from the given
        initial guess.
        """
        initial_guess = np.asarray(initial_guess)
        if initial_guess.size != self.n_hyperpars:
            raise ValueError(
                f"[ GpLinearInverter error ] There are a total of "
                f"{self.n_hyperpars} hyper-parameters, but "
                f"{initial_guess.size} values were given in 'initial_guess'."
            )
        hp_bounds = [*self.mean.bounds, *self.cov.bounds]
        result = minimize(
            fun=lambda t: -self.marginal_likelihood(t),
            x0=initial_guess,
            method="Nelder-Mead",
            bounds=hp_bounds,
        )
        return result.x
