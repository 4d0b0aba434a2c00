"""Rectangular parameter bounds with infinite-reflection maps.

JAX rebuild of the reference ``Bounds`` class
(reference: inference/mcmc/utilities.py:98-162). Validation happens eagerly
on the host at construction; the reflection maps are pure jax functions so
they can be used inside jitted sampler step functions (e.g. the bounded
leapfrog integrator, reflecting Gibbs proposals and ensemble stretch moves).
"""

import numpy as np
import jax.numpy as jnp


class Bounds:
    """
    Rectangular bounds on parameter values.

    :param lower: lower bounds for each parameter as a 1D array.
    :param upper: upper bounds for each parameter as a 1D array.
    """

    def __init__(self, lower, upper, error_source: str = "Bounds"):
        lo = np.asarray(lower, dtype=float).squeeze()
        up = np.asarray(upper, dtype=float).squeeze()
        lo = np.atleast_1d(lo)
        up = np.atleast_1d(up)

        if lo.ndim > 1 or up.ndim > 1:
            raise ValueError(
                f"[ {error_source} error ] Lower and upper bounds must be "
                f"one-dimensional arrays, but instead have dimensions "
                f"{lo.ndim} and {up.ndim} respectively."
            )
        if lo.size != up.size:
            raise ValueError(
                f"[ {error_source} error ] Lower and upper bounds must be arrays "
                f"of equal size, but have sizes {lo.size} and {up.size}."
            )
        if (lo >= up).any():
            raise ValueError(
                f"[ {error_source} error ] All given upper bounds must be larger "
                f"than the corresponding lower bounds."
            )

        # host copies for validation / serialisation
        self.lower = lo
        self.upper = up
        self.width = up - lo
        self.n_bounds = self.width.size

        # device copies for use inside jitted code
        self._lo = jnp.asarray(lo)
        self._up = jnp.asarray(up)
        self._w = jnp.asarray(self.width)

    def validate_start_point(self, start, error_source: str = "Bounds"):
        start = np.asarray(start)
        if self.n_bounds != start.size:
            raise ValueError(
                f"[ {error_source} error ] The number of parameters ({start.size}) "
                f"does not match the given number of bounds ({self.n_bounds})."
            )
        if not self.inside(start):
            raise ValueError(
                f"[ {error_source} error ] Starting location for the chain is "
                f"outside specified bounds."
            )

    def reflect(self, theta):
        """Map arbitrary positions into the bounds by infinite reflection."""
        q, rem = jnp.divmod(theta - self._lo, self._w)
        n = q % 2
        return self._lo + (1 - 2 * n) * rem + n * self._w

    def reflect_momenta(self, theta):
        """
        Reflect positions into the bounds, also returning the +-1 sign flips
        to apply to the conjugate momenta (for HMC bounded leapfrog).
        """
        q, rem = jnp.divmod(theta - self._lo, self._w)
        n = q % 2
        reflection = 1 - 2 * n
        return self._lo + reflection * rem + n * self._w, reflection

    def inside(self, theta) -> bool:
        theta = np.asarray(theta)
        return bool(((theta >= self.lower) & (theta <= self.upper)).all())

    def inside_device(self, theta):
        """Traceable version of ``inside`` returning a jax boolean scalar."""
        return ((theta >= self._lo) & (theta <= self._up)).all()


def reflect_to_bounds(theta, lower, upper):
    """
    Functional infinite-reflection map usable with per-parameter bound arrays
    inside jitted kernels (no Bounds object required).
    """
    width = upper - lower
    q, rem = jnp.divmod(theta - lower, width)
    n = q % 2
    return lower + (1 - 2 * n) * rem + n * width
