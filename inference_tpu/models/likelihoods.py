"""Likelihood functors (Gaussian, Cauchy, Logistic).

JAX rebuild of the reference likelihood classes
(reference: inference/likelihoods.py:9-274). Behavioural parity:

- ``__call__(theta)`` returns the log-likelihood given model parameters.
- ``gradient(theta)`` returns d(logL)/d(theta). Where the reference requires a
  user-supplied ``forward_model_jacobian`` (reference: likelihoods.py:267-274),
  this rebuild falls back to **automatic differentiation** of the forward
  model when no jacobian is supplied and the model is jax-traceable.
- ``cost`` / ``cost_gradient`` negations.

All arithmetic is jax, so instances are traceable closures: they can be
passed directly as the ``posterior`` argument of the samplers, vmapped over
chains, and differentiated for HMC.
"""

from abc import ABC, abstractmethod
import numpy as np
import jax
import jax.numpy as jnp

from ..utils.dtypes import default_float


class Likelihood(ABC):
    """
    Base class for likelihood functors.

    :param y_data: measured data as a 1D array.
    :param uncertainties: positive standard deviations / uncertainties per datum.
    :param uncertainties_name: attribute name for the uncertainties.
    :param forward_model: callable mapping parameters -> predictions of y_data.
    :param forward_model_jacobian: optional callable returning the (n_data,
        n_params) jacobian of the forward model. If omitted, gradients are
        computed by jax autodiff of ``forward_model``.
    """

    def __init__(
        self,
        y_data,
        uncertainties,
        uncertainties_name: str,
        forward_model: callable,
        forward_model_jacobian: callable = None,
    ):
        if not callable(forward_model):
            raise ValueError("Given forward_model object must be callable")
        if forward_model_jacobian is not None and not callable(forward_model_jacobian):
            raise ValueError("Given forward_model_jacobian object must be callable")

        y = np.asarray(y_data, dtype=float).squeeze()
        errs = np.asarray(uncertainties, dtype=float).squeeze()
        y = np.atleast_1d(y)
        errs = np.atleast_1d(errs)

        if y.size != errs.size:
            raise ValueError(
                f"y_data and {uncertainties_name} arguments must have the same "
                f"number of elements"
            )
        if y.ndim > 1 or errs.ndim > 1:
            raise ValueError(
                f"y_data and {uncertainties_name} arguments must have either "
                f"0 or 1 dimensions"
            )
        if (errs <= 0).any():
            raise ValueError(
                f"All values in {uncertainties_name} argument must be greater "
                f"than zero"
            )

        dtype = default_float()
        self.y = jnp.asarray(y, dtype=dtype)
        setattr(self, uncertainties_name, jnp.asarray(errs, dtype=dtype))
        self.model = forward_model
        self.model_jacobian = forward_model_jacobian
        self.n_data = int(y.size)

    @abstractmethod
    def _log_likelihood(self, predictions):
        pass

    @abstractmethod
    def _dL_dF(self, predictions):
        """Derivative of the log-likelihood w.r.t. the model predictions."""
        pass

    def __call__(self, theta):
        """Log-likelihood value for the given model parameters."""
        return self._log_likelihood(self.model(jnp.asarray(theta)))

    def gradient(self, theta):
        """
        Gradient of the log-likelihood with respect to the model parameters.

        Uses the user-supplied jacobian when given (chain rule, as the
        reference does); otherwise reverse-mode autodiff through the forward
        model.
        """
        theta = jnp.asarray(theta)
        if self.model_jacobian is not None:
            predictions = self.model(theta)
            jac = jnp.asarray(self.model_jacobian(theta))
            return self._dL_dF(predictions) @ jac
        return jax.grad(lambda t: self._log_likelihood(self.model(t)))(theta)

    def cost(self, theta):
        return -self.__call__(theta)

    def cost_gradient(self, theta):
        return -self.gradient(theta)


class GaussianLikelihood(Likelihood):
    r"""
    Gaussian likelihood: ``logL = -0.5 sum(((y - F)/sigma)^2) + const``
    (reference: inference/likelihoods.py:122-167).
    """

    def __init__(self, y_data, sigma, forward_model, forward_model_jacobian=None):
        super().__init__(y_data, sigma, "sigma", forward_model, forward_model_jacobian)
        self.inv_sigma = 1.0 / self.sigma
        self.inv_sigma_sqr = self.inv_sigma**2
        self.normalisation = (
            -jnp.log(self.sigma).sum() - 0.5 * jnp.log(2 * jnp.pi) * self.n_data
        )

    def _log_likelihood(self, predictions):
        z = (self.y - predictions) * self.inv_sigma
        return -0.5 * (z**2).sum() + self.normalisation

    def _dL_dF(self, predictions):
        return (self.y - predictions) * self.inv_sigma_sqr


class CauchyLikelihood(Likelihood):
    r"""
    Cauchy likelihood: ``logL = -sum(log(1 + z^2)) + const`` with
    ``z = (y - F)/gamma`` (reference: inference/likelihoods.py:170-215).
    """

    def __init__(self, y_data, gamma, forward_model, forward_model_jacobian=None):
        super().__init__(y_data, gamma, "gamma", forward_model, forward_model_jacobian)
        self.inv_gamma = 1.0 / self.gamma
        self.normalisation = -jnp.log(jnp.pi * self.gamma).sum()

    def _log_likelihood(self, predictions):
        z = (self.y - predictions) * self.inv_gamma
        return -jnp.log1p(z**2).sum() + self.normalisation

    def _dL_dF(self, predictions):
        z = (self.y - predictions) * self.inv_gamma
        return 2 * self.inv_gamma * z / (1 + z**2)


class LogisticLikelihood(Likelihood):
    r"""
    Logistic likelihood with scale ``sigma * sqrt(3)/pi`` so that ``sigma``
    is the distribution standard deviation
    (reference: inference/likelihoods.py:218-264).
    """

    def __init__(self, y_data, sigma, forward_model, forward_model_jacobian=None):
        super().__init__(y_data, sigma, "sigma", forward_model, forward_model_jacobian)
        self.scale = self.sigma * (jnp.sqrt(3.0) / jnp.pi)
        self.inv_scale = 1.0 / self.scale
        self.normalisation = -jnp.log(self.scale).sum()

    def _log_likelihood(self, predictions):
        z = (self.y - predictions) * self.inv_scale
        return z.sum() - 2 * jnp.logaddexp(0.0, z).sum() + self.normalisation

    def _dL_dF(self, predictions):
        z = (self.y - predictions) * self.inv_scale
        return (2 / (1 + jnp.exp(-z)) - 1) * self.inv_scale
