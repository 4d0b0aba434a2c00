"""Device linear-algebra helpers.

``jnp.eye(n)`` called inside a traced function is evaluated eagerly (it
depends on no tracers) and embedded into the compiled program as a dense
N x N constant — at N = 8192 that is a 256MB HLO literal, which makes
compilation payloads enormous. These helpers build identities and diagonal
updates *from traced operands*, so they lower to cheap device ops instead.
"""

import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.linalg import solve_triangular


def add_diagonal(K, value):
    """Return ``K + value * I`` without materialising an identity constant.

    ``value`` may be a scalar or a length-N vector."""
    n = K.shape[0]
    idx = jnp.arange(n)
    return K.at[idx, idx].add(value)


def identity_like(K):
    """An identity matrix with the shape/dtype of ``K``, built from ``K``
    (traced) rather than from a constant."""
    n = K.shape[0]
    idx = jnp.arange(n)
    return jnp.zeros_like(K).at[idx, idx].set(1.0)


def blocked_cholesky(
    K, block: int = 2048, method: str = "inv", remat: bool = True
):
    """Right-looking blocked Cholesky, statically unrolled over block
    columns.

    The O(N^3) trailing updates are explicit (shrinking,
    statically-shaped) HIGHEST-precision matmuls — exactly N^3/3 flops
    of matrix-multiply work — with only the ``block x block`` diagonal
    factorisations left to the native factorisation. Its autodiff VJP is
    made of matmuls too. Differentiable (composed of primitives with VJPs); with
    ``remat`` each block step recomputes in the backward pass so peak
    memory stays O(N^2).

    :param block: panel width. Each unrolled step costs one
        ``block x block`` Cholesky, one panel solve, and one
        ``rem x rem x block`` matmul; ``N/block`` steps are unrolled
        statically (keep N/block <= ~32 for sane compile times).
    :param method: how the off-diagonal panel is formed —
        ``"inv"`` explicitly inverts the diagonal factor (two small
        triangular solves) so the panel is one matmul: fastest, error
        ~cond(L_kk) * eps on the panel; ``"trsm"`` uses a triangular
        solve against the full panel: the textbook-stable choice, slower
        when XLA expands it sequentially.
    :param remat: wrap each block step in ``jax.checkpoint``.
    """
    if method not in ("inv", "trsm"):
        raise ValueError(
            f"'method' must be 'inv' or 'trsm', got {method!r}"
        )
    n = K.shape[0]
    if n <= block:
        return jnp.linalg.cholesky(K)
    pad = (-n) % block
    if pad:
        # embed K as blockdiag(K, I): its factor is blockdiag(L, I)
        K = jnp.pad(K, ((0, pad), (0, pad)))
        idx = jnp.arange(n, n + pad)
        K = K.at[idx, idx].set(1.0)
    n_padded = n + pad
    n_blocks = n_padded // block

    hi = jax.lax.Precision.HIGHEST

    def step(trailing):
        """One block column: factor the diagonal block, form the panel
        below it, and downdate the trailing matrix."""
        Lkk = jnp.linalg.cholesky(trailing[:block, :block])
        below = trailing[block:, :block]
        if method == "inv":
            inv_Lkk = solve_triangular(
                Lkk, identity_like(Lkk), lower=True
            )
            panel = jnp.matmul(below, inv_Lkk.T, precision=hi)
        else:
            panel = solve_triangular(
                Lkk, below.T, lower=True
            ).T
        rest = trailing[block:, block:] - jnp.matmul(
            panel, panel.T, precision=hi
        )
        return Lkk, panel, rest

    if remat:
        step = jax.checkpoint(step)

    cols = []
    trailing = K
    for k in range(n_blocks):
        if trailing.shape[0] == block:
            cols.append((jnp.linalg.cholesky(trailing), None))
            break
        Lkk, panel, trailing = step(trailing)
        cols.append((Lkk, panel))

    # assemble: column block k carries [0; L_kk; panel] at offset k*block
    L = jnp.zeros((n_padded, n_padded), K.dtype)
    for k, (Lkk, panel) in enumerate(cols):
        i0 = k * block
        L = lax.dynamic_update_slice(L, Lkk, (i0, i0))
        if panel is not None:
            L = lax.dynamic_update_slice(L, panel, (i0 + block, i0))
    return L[:n, :n]


def blocked_tril_inverse(L, block: int = 2048):
    """Explicit inverse of a lower-triangular matrix by blocked
    forward substitution — every O(N^3) term is a HIGHEST-precision
    matmul (the matmul-shaped route to ``L^-1`` used by the analytic
    marginal-likelihood gradient).

    Block recurrence (padding embeds L as blockdiag(L, I)):
    ``X_ii = L_ii^-1`` (one small triangular solve), and for i > j
    ``X_ij = -X_ii @ sum_{j<=k<i} L_ik X_kj`` — flops n^3/3, all matmul.
    """
    n = L.shape[0]
    if n <= block:
        return solve_triangular(L, identity_like(L), lower=True)
    pad = (-n) % block
    if pad:
        L = jnp.pad(L, ((0, pad), (0, pad)))
        idx = jnp.arange(n, n + pad)
        L = L.at[idx, idx].set(1.0)
    nb = (n + pad) // block
    hi = jax.lax.Precision.HIGHEST

    def blk(i, j):
        return lax.dynamic_slice(
            L, (i * block, j * block), (block, block)
        )

    X = [[None] * nb for _ in range(nb)]
    for i in range(nb):
        X[i][i] = solve_triangular(
            blk(i, i), identity_like(L[:block, :block]), lower=True
        )
    for j in range(nb):
        for i in range(j + 1, nb):
            # S = L[i, jb:ib] @ vstack(X[k][j], k=j..i-1)
            row = lax.dynamic_slice(
                L, (i * block, j * block), (block, (i - j) * block)
            )
            col = jnp.concatenate([X[k][j] for k in range(j, i)], axis=0)
            S = jnp.matmul(row, col, precision=hi)
            X[i][j] = -jnp.matmul(X[i][i], S, precision=hi)

    out = jnp.zeros_like(L)
    for i in range(nb):
        for j in range(i + 1):
            out = lax.dynamic_update_slice(
                out, X[i][j], (i * block, j * block)
            )
    return out[:n, :n]


def tril_gram(X, block: int = 2048):
    """``X^T X`` for a lower-triangular ``X``, exploiting the triangular
    structure blockwise: ``G_ij = sum_{k >= max(i,j)} X_ki^T X_kj`` — the
    zero blocks above the diagonal are never touched, so the flop count
    is n^3/3 instead of the dense product's n^3 (counting one matmul
    flop per multiply-add pair as 2). Used with ``blocked_tril_inverse``
    to form ``K^-1 = L^-T L^-1`` as pure matmul work."""
    n = X.shape[0]
    hi = jax.lax.Precision.HIGHEST
    if n <= block:
        return jnp.matmul(X.T, X, precision=hi)
    pad = (-n) % block
    if pad:
        # zero-padding: padded rows/cols of X contribute nothing to X^T X
        X = jnp.pad(X, ((0, pad), (0, pad)))
    nb = (n + pad) // block

    def blk(i, j):
        return lax.dynamic_slice(
            X, (i * block, j * block), (block, block)
        )

    G = jnp.zeros_like(X)
    for i in range(nb):
        for j in range(i, nb):
            # both columns i and j of X are nonzero from row j down
            col_i = jnp.concatenate(
                [blk(k, i) for k in range(j, nb)], axis=0
            )
            col_j = jnp.concatenate(
                [blk(k, j) for k in range(j, nb)], axis=0
            )
            Gij = jnp.matmul(col_i.T, col_j, precision=hi)
            G = lax.dynamic_update_slice(G, Gij, (i * block, j * block))
            if i != j:
                G = lax.dynamic_update_slice(
                    G, Gij.T, (j * block, i * block)
                )
    return G[:n, :n]
