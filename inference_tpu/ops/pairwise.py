"""Pairwise-distance and covariance-matrix assembly.

This replaces the reference's precomputed ``N x N x D`` displacement tensor
(reference: inference/gp/covariance.py:218-219) with on-the-fly assembly
of the scaled squared distances ``D_ij = sum_k ((u_ik - v_jk) / l_k)^2``,
in one of two forms:

- the matmul form ``|u'_i|^2 + |v'_j|^2 - 2 u'_i . v'_j`` (``u' = u / l``),
  whose cross term is one matrix product. In float32 it cancels badly:
  ``D_ij`` carries an absolute error of ~``eps32 * |u'|^2``, which is large
  next to the small distances that dominate a smooth kernel;
- the difference form, summed over the (small) feature dimension. XLA
  fuses it with the exponential epilogue into one pass that writes only
  the ``N x N`` result, and it is exact at ``D_ij = 0``.

Memory is O(N^2) (the kernel matrix itself) in both, instead of O(N^2 D).
"""

import jax
import jax.numpy as jnp


def scaled_sq_distances(u, v, lengthscales):
    """
    Pairwise squared distances between rows of ``u`` (M, D) and ``v`` (N, D)
    after per-dimension scaling by ``lengthscales`` (D,), in the matmul
    form. Returns (M, N).
    """
    u = jnp.atleast_2d(jnp.asarray(u))
    v = jnp.atleast_2d(jnp.asarray(v))
    ls = jnp.asarray(lengthscales)
    us = u / ls[None, :]
    vs = v / ls[None, :]
    uu = (us * us).sum(axis=1)
    vv = (vs * vs).sum(axis=1)
    # full float32 precision: a reduced-precision (TF32) product is far
    # too coarse for distance cancellation
    cross = jnp.dot(us, vs.T, precision=jax.lax.Precision.HIGHEST)
    # cancellation can leave tiny negative values (~ -1e-16); these are
    # harmless for the exp/power kernels applied downstream, and clamping
    # with max(d, 0) would corrupt second derivatives at d == 0 (jax
    # assigns the tie a 0.5 subgradient), so the raw value is returned
    return uu[:, None] + vv[None, :] - 2.0 * cross


def scaled_sq_differences(u, v, lengthscales):
    """
    The same distances as ``scaled_sq_distances`` in the difference form
    ``sum_k ((u_ik - v_jk) / l_k)^2``: one elementwise pass per feature
    dimension, free of the matmul form's float32 cancellation.
    """
    u = jnp.atleast_2d(jnp.asarray(u))
    v = jnp.atleast_2d(jnp.asarray(v))
    ls = jnp.asarray(lengthscales)
    us = u / ls[None, :]
    vs = v / ls[None, :]
    return sum(
        (us[:, k, None] - vs[None, :, k]) ** 2 for k in range(us.shape[1])
    )


def sqexp_covariance(u, v, amplitude, lengthscales):
    """
    Squared-exponential covariance block
    ``A^2 exp(-0.5 sum_k ((u_ik - v_jk)/l_k)^2)``. Float32 inputs use the
    difference form (no cancellation); float64 inputs, whose matmul-form
    error is ~1e-16, use the matmul form. Differentiable in all four
    arguments, in forward and reverse mode.
    """
    u = jnp.atleast_2d(jnp.asarray(u))
    v = jnp.atleast_2d(jnp.asarray(v))
    ls = jnp.asarray(lengthscales)
    if u.dtype == jnp.float32 and v.dtype == jnp.float32:
        d = scaled_sq_differences(u, v, ls)
    else:
        d = scaled_sq_distances(u, v, ls)
    return (amplitude**2) * jnp.exp(-0.5 * d)
