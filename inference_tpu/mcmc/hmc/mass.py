"""Particle-mass abstractions for HMC kinetic energy.

JAX rebuild of the reference mass classes
(reference: inference/mcmc/hmc/mass.py:9-117). Validation happens eagerly on
the host; the velocity / momentum-sampling maps are pure jax closures handed
to the compiled HMC kernel.
"""

from abc import ABC, abstractmethod

import numpy as np
import jax
import jax.numpy as jnp
from scipy.linalg import solve_triangular, issymmetric


class ParticleMass(ABC):
    inv_mass = None
    kind: str

    @abstractmethod
    def get_velocity(self, r):
        """Map a momentum vector to a velocity (apply the inverse mass)."""

    @abstractmethod
    def sample_momentum(self, key, dtype):
        """Draw a momentum sample from the Gaussian kinetic-energy density."""


class ScalarMass(ParticleMass):
    kind = "scalar"

    def __init__(self, inv_mass: float, n_parameters: int):
        self.inv_mass = float(inv_mass)
        self.sqrt_mass = 1.0 / np.sqrt(self.inv_mass)
        self.n_parameters = n_parameters

    def get_velocity(self, r):
        return r * self.inv_mass

    def sample_momentum(self, key, dtype):
        return jax.random.normal(key, (self.n_parameters,), dtype) * jnp.asarray(
            self.sqrt_mass, dtype
        )


class VectorMass(ParticleMass):
    kind = "vector"

    def __init__(self, inv_mass: np.ndarray, n_parameters: int):
        inv_mass = np.asarray(inv_mass, dtype=float)
        valid = (
            inv_mass.ndim == 1
            and inv_mass.size == n_parameters
            and (inv_mass > 0.0).all()
        )
        if not valid:
            raise ValueError(
                f"[ VectorMass error ] The inverse-mass vector must be a 1D array "
                f"of size equal to the number of model parameters "
                f"({n_parameters}) containing only positive values."
            )
        self.inv_mass = inv_mass
        self.n_parameters = n_parameters
        self._inv_mass_dev = jnp.asarray(inv_mass)
        self._sqrt_mass_dev = jnp.asarray(1.0 / np.sqrt(inv_mass))

    def get_velocity(self, r):
        return r * self._inv_mass_dev.astype(r.dtype)

    def sample_momentum(self, key, dtype):
        return jax.random.normal(
            key, (self.n_parameters,), dtype
        ) * self._sqrt_mass_dev.astype(dtype)


class MatrixMass(ParticleMass):
    kind = "matrix"

    def __init__(self, inv_mass: np.ndarray, n_parameters: int):
        inv_mass = np.asarray(inv_mass, dtype=float)
        valid = (
            inv_mass.ndim == 2
            and inv_mass.shape[0] == inv_mass.shape[1]
            and issymmetric(inv_mass)
        )
        if not valid:
            raise ValueError(
                "[ MatrixMass error ] The given inverse-mass matrix must be a "
                "valid covariance matrix, i.e. 2 dimensional, square and symmetric."
            )
        if inv_mass.shape[0] != n_parameters:
            raise ValueError(
                f"[ MatrixMass error ] The dimensions of the given inverse-mass "
                f"matrix {inv_mass.shape} do not match the given number of model "
                f"parameters ({n_parameters})."
            )
        self.inv_mass = inv_mass
        self.n_parameters = n_parameters
        # momentum covariance is M = (M^-1)^-1; sample via L @ z where
        # L = inv(chol(M^-1))^T (reference: hmc/mass.py:86-88)
        iL = np.linalg.cholesky(inv_mass)
        self.L = solve_triangular(iL, np.eye(n_parameters), lower=True).T
        self._inv_mass_dev = jnp.asarray(inv_mass)
        self._L_dev = jnp.asarray(self.L)

    def get_velocity(self, r):
        return self._inv_mass_dev.astype(r.dtype) @ r

    def sample_momentum(self, key, dtype):
        z = jax.random.normal(key, (self.n_parameters,), dtype)
        return self._L_dev.astype(dtype) @ z


def get_particle_mass(inverse_mass, n_parameters: int) -> ParticleMass:
    """Dispatch scalar / 1D / 2D inverse-mass specifications."""
    if np.isscalar(inverse_mass):
        return ScalarMass(float(inverse_mass), n_parameters)

    inverse_mass = np.asarray(inverse_mass)
    if inverse_mass.ndim == 0:
        return ScalarMass(float(inverse_mass), n_parameters)
    if inverse_mass.ndim == 1:
        return VectorMass(inverse_mass, n_parameters)
    return MatrixMass(inverse_mass, n_parameters)
