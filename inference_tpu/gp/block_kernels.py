"""Kernel adapters for the matrix-free large-scale GP tiers.

``LargeScaleGP`` / ``LargeScaleGpLinearInverter`` never materialise the
covariance matrix: they need only (a) blocked cross-covariance **rows**
``K(xa, xb; theta)`` evaluated on the fly (each block one fused
elementwise pass), (b) the prior point variance
``K(x, x; theta)`` for diagonals/preconditioners, and (c) any
white-noise variance the kernel adds to the *data* diagonal. A
``BlockKernel`` packages exactly those three maps over a single flat
hyperparameter vector, so the solvers and the stochastic-LML ``fit()``
(autodiff through ``rows``) are kernel-generic.

Supported dense-path kernels (``as_block_kernel``):

- ``SquaredExponential`` — theta ``[ln A, ln l_1..l_D]``; the rows run
  through ``ops.pairwise.sqexp_covariance`` and this is the only kernel
  with a df64 solver tier.
- ``RationalQuadratic`` — theta ``[ln A, ln alpha, ln l_1..l_D]``
  (reference: inference/gp/covariance.py:282-368); f32/mixed tiers.
- either of the above ``+ WhiteNoise()`` — the noise hyperparameter
  folds into the system diagonal (the reference's WhiteNoise has zero
  off-data cross-covariance, reference: covariance.py:160-169), so it
  costs the matvec nothing.

Unsupported kernels (``ChangePoint``, ``HeteroscedasticNoise``, other
compositions) raise an informative ``ValueError`` at construction —
they remain available on the dense ``GpRegressor`` path.
"""

import numpy as np
import jax
import jax.numpy as jnp

from .covariance import (
    CompositeCovariance,
    CovarianceFunction,
    RationalQuadratic,
    SquaredExponential,
    WhiteNoise,
)
from ..ops.pairwise import sqexp_covariance, scaled_sq_distances

_HI = jax.lax.Precision.HIGHEST


class BlockKernel:
    """Flat-theta kernel maps for the blocked matrix-free solvers.

    Subclasses define ``name``, ``supports_df64``, ``n_params(d)`` and
    the three maps ``rows`` / ``amp2`` / ``noise_variance`` (all pure
    jax, dtype-generic so the float64 refinement paths reuse them), plus
    ``rows_host64`` for host-precision prediction/residual work.
    """

    supports_df64 = False

    def n_params(self, n_dims: int) -> int:
        raise NotImplementedError

    def rows(self, xa, xb, theta):
        """Cross-covariance block K(xa, xb) — white noise excluded."""
        raise NotImplementedError

    def amp2(self, theta):
        """Prior point variance K(x, x) excluding white noise (traced)."""
        raise NotImplementedError

    def noise_variance(self, theta):
        """White-noise variance added to the data diagonal (traced);
        0 for kernels without a noise component."""
        return jnp.zeros((), jnp.asarray(theta).dtype)

    def rows_host64(self, q, x, theta) -> np.ndarray:
        """Host float64 cross-covariance rows (numpy in, numpy out)."""
        raise NotImplementedError

    def amp2_host(self, theta) -> float:
        raise NotImplementedError

    def noise_variance_host(self, theta) -> float:
        return 0.0


class SqExpBlock(BlockKernel):
    name = "SquaredExponential"
    supports_df64 = True

    def n_params(self, n_dims):
        return n_dims + 1

    def rows(self, xa, xb, theta):
        theta = jnp.asarray(theta)
        return sqexp_covariance(
            xa, xb, jnp.exp(theta[0]), jnp.exp(theta[1:])
        )

    def amp2(self, theta):
        return jnp.exp(2.0 * jnp.asarray(theta)[0])

    def rows_host64(self, q, x, theta):
        h = np.asarray(theta, np.float64)
        ls = np.exp(h[1:])
        amp2 = float(np.exp(2.0 * h[0]))
        qs = np.asarray(q, np.float64) / ls[None, :]
        xs = np.asarray(x, np.float64) / ls[None, :]
        d2 = (
            (qs**2).sum(axis=1)[:, None]
            + (xs**2).sum(axis=1)[None, :]
            - 2.0 * (qs @ xs.T)
        )
        np.maximum(d2, 0.0, out=d2)
        return amp2 * np.exp(-0.5 * d2)

    def amp2_host(self, theta):
        return float(np.exp(2.0 * np.asarray(theta, np.float64)[0]))


class RQBlock(BlockKernel):
    name = "RationalQuadratic"

    def n_params(self, n_dims):
        return n_dims + 2

    def rows(self, xa, xb, theta):
        theta = jnp.asarray(theta)
        a = jnp.exp(theta[0])
        k = jnp.exp(theta[1])
        Z = 0.5 * scaled_sq_distances(xa, xb, jnp.exp(theta[2:]))
        # the matmul distance form can leave tiny negative Z; clamp so
        # the fractional power stays real (d/dZ at 0 is finite for RQ)
        return (a**2) * (1.0 + jnp.maximum(Z, 0.0) / k) ** (-k)

    def amp2(self, theta):
        return jnp.exp(2.0 * jnp.asarray(theta)[0])

    def rows_host64(self, q, x, theta):
        h = np.asarray(theta, np.float64)
        amp2 = float(np.exp(2.0 * h[0]))
        k = float(np.exp(h[1]))
        ls = np.exp(h[2:])
        qs = np.asarray(q, np.float64) / ls[None, :]
        xs = np.asarray(x, np.float64) / ls[None, :]
        d2 = (
            (qs**2).sum(axis=1)[:, None]
            + (xs**2).sum(axis=1)[None, :]
            - 2.0 * (qs @ xs.T)
        )
        np.maximum(d2, 0.0, out=d2)
        return amp2 * (1.0 + 0.5 * d2 / k) ** (-k)

    def amp2_host(self, theta):
        return float(np.exp(2.0 * np.asarray(theta, np.float64)[0]))


class NoisyBlock(BlockKernel):
    """A smooth base kernel plus a WhiteNoise component. The flat theta
    follows the dense ``CompositeCovariance`` slice order: the base's
    parameters occupy their component slice, the noise ``ln sigma_w``
    its own — so hyperparameter vectors are interchangeable between the
    dense and matrix-free paths."""

    def __init__(self, base: BlockKernel, base_first: bool = True):
        self.base = base
        self.base_first = base_first
        self.name = (
            f"{base.name}+WhiteNoise"
            if base_first
            else f"WhiteNoise+{base.name}"
        )

    def n_params(self, n_dims):
        return self.base.n_params(n_dims) + 1

    def _split(self, theta):
        theta = jnp.asarray(theta)
        if self.base_first:
            return theta[:-1], theta[-1]
        return theta[1:], theta[0]

    def _split_host(self, theta):
        h = np.asarray(theta, np.float64)
        if self.base_first:
            return h[:-1], float(h[-1])
        return h[1:], float(h[0])

    def rows(self, xa, xb, theta):
        tb, _ = self._split(theta)
        return self.base.rows(xa, xb, tb)

    def amp2(self, theta):
        tb, _ = self._split(theta)
        return self.base.amp2(tb)

    def noise_variance(self, theta):
        _, tw = self._split(theta)
        return jnp.exp(2.0 * tw)

    def rows_host64(self, q, x, theta):
        tb, _ = self._split_host(theta)
        return self.base.rows_host64(q, x, tb)

    def amp2_host(self, theta):
        tb, _ = self._split_host(theta)
        return self.base.amp2_host(tb)

    def noise_variance_host(self, theta):
        _, tw = self._split_host(theta)
        return float(np.exp(2.0 * tw))


def _base_block(component) -> BlockKernel:
    if isinstance(component, SquaredExponential):
        return SqExpBlock()
    if isinstance(component, RationalQuadratic):
        return RQBlock()
    return None


def as_block_kernel(kernel, error_source: str) -> BlockKernel:
    """Resolve a dense-path kernel (class or instance) to its
    ``BlockKernel`` adapter, or raise an informative ``ValueError``."""
    if isinstance(kernel, BlockKernel):
        return kernel
    if isinstance(kernel, type):
        if issubclass(kernel, BlockKernel):
            return kernel()
        if issubclass(kernel, CovarianceFunction):
            try:
                kernel = kernel()
            except TypeError:
                # e.g. ChangePoint requires constructor arguments; it is
                # unsupported here either way — report that, not the
                # instantiation failure
                raise ValueError(
                    f"[ {error_source} error ] Kernel "
                    f"{kernel.__name__!r} is not supported by the "
                    f"matrix-free solver tiers. Supported kernels: "
                    f"SquaredExponential, RationalQuadratic, and either "
                    f"+ WhiteNoise; use the dense GpRegressor for other "
                    f"kernels."
                )
    if isinstance(kernel, CompositeCovariance):
        comps = kernel.components
        smooth = [c for c in comps if _base_block(c) is not None]
        noise = [c for c in comps if isinstance(c, WhiteNoise)]
        if len(smooth) == 1 and len(noise) == 1 and len(comps) == 2:
            return NoisyBlock(
                _base_block(smooth[0]),
                base_first=comps[0] is smooth[0],
            )
        names = [type(c).__name__ for c in comps]
        raise ValueError(
            f"[ {error_source} error ] Unsupported kernel composition "
            f"{' + '.join(names)} for the matrix-free solver tiers. "
            f"Supported: SquaredExponential, RationalQuadratic, and "
            f"either of those + WhiteNoise. Other kernels remain "
            f"available on the dense GpRegressor path."
        )
    blk = _base_block(kernel) if isinstance(kernel, CovarianceFunction) else None
    if blk is not None:
        return blk
    raise ValueError(
        f"[ {error_source} error ] Kernel {type(kernel).__name__!r} is not "
        f"supported by the matrix-free solver tiers (its blocked "
        f"row evaluation is not implemented). Supported kernels: "
        f"SquaredExponential, RationalQuadratic, and either + WhiteNoise; "
        f"use the dense GpRegressor for other kernels."
    )
