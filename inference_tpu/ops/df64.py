"""The df64 covariance tier: squared-exponential matvecs, entry stores
and contractions evaluated in native float64.

Every entry point takes the pre-scaled coordinates ``us = x / l`` as a
float32 pair ``(hi, lo)`` with ``us = hi + lo`` exactly (``split_f64``),
so callers keep a float64-accurate copy of the data in float32 storage,
and returns float64. Entries are evaluated row block by row block
(``lax.map``), so no ``N x N`` float64 temporary exists beyond one
block; the stored tiers keep the entries as a float32 pair (8 bytes per
entry, float64-accurate to ~2^-48) or rounded to one float32 word
(4 bytes per entry, 2^-24 quantisation).

Padding contract: every row count is a multiple of ``_PAD`` (128); callers
pad with rows whose right-hand-side entries are zero, which are inert.

The reference library evaluates the same quantities in host float64
(reference: inference/gp/regression.py:239-244).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

_PAD = 128  # row-count multiple required by every entry point
_HI = lax.Precision.HIGHEST


def split_f64(a):
    """Host helper: split float64 array(s) into a (hi, lo) float32 pair."""
    a = np.asarray(a, np.float64)
    hi = a.astype(np.float32)
    lo = (a - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def split_pair(a):
    """Device (traceable) split of a float64 array into a (hi, lo) float32
    pair with ``hi + lo == a`` to ~2^-48. The optimization barrier keeps
    XLA from folding the float64 -> float32 -> float64 round trip of
    ``hi`` (which excess-precision simplification may do on the GPU),
    which would leave ``lo`` zero and the pair only float32-accurate."""
    hi = lax.optimization_barrier(a.astype(jnp.float32))
    return hi, (a - hi.astype(jnp.float64)).astype(jnp.float32)


def _require_x64(name):
    if not jax.config.read("jax_enable_x64"):
        raise ValueError(
            f"{name} requires jax_enable_x64 (the entries and the returned "
            f"arrays are float64)"
        )


def _check_rows(name, n):
    if n % _PAD != 0:
        raise ValueError(
            f"[ {name} error ] n ({n}) must be a multiple of {_PAD}; pad "
            f"the data rows (zero-padded right-hand-side entries are inert)."
        )


def _check_block(name, V, n):
    if V.ndim != 2:
        raise ValueError(
            f"[ {name} error ] V must be 2D (n, q); reshape single vectors "
            f"to (n, 1)."
        )
    if V.shape[0] != n:
        raise ValueError(
            f"[ {name} error ] V has {V.shape[0]} rows but the operator has "
            f"{n} columns."
        )


def _pair64(hi, lo):
    return jnp.asarray(hi, jnp.float32).astype(jnp.float64) + jnp.asarray(
        lo, jnp.float32
    ).astype(jnp.float64)


def _by_row_blocks(fn, *row_arrays):
    """``fn`` over ``_PAD``-row blocks of ``row_arrays`` (each
    (n_rows, ...)), results concatenated along rows. Every block has the
    same shape whatever the row count, so a row's result does not depend
    on how many rows are evaluated with it: square, rectangular and
    row-sharded calls agree bitwise."""
    n_rows = row_arrays[0].shape[0]
    blocks = tuple(
        a.reshape(n_rows // _PAD, _PAD, *a.shape[1:]) for a in row_arrays
    )
    out = lax.map(lambda xs: fn(*xs), blocks)
    return jax.tree.map(lambda o: o.reshape(n_rows, *o.shape[2:]), out)


def _entries64(rows, cols):
    """``exp(-0.5 ||r_i - c_j||^2)`` in float64 for a row block, summed in
    the difference form (exact for scaled coordinates of modest size)."""
    d2 = sum(
        (rows[:, k, None] - cols[None, :, k]) ** 2 for k in range(rows.shape[1])
    )
    return jnp.exp(-0.5 * d2)


@jax.jit
def _rect_matmat(rows, cols, V):
    def block(r):
        return jnp.dot(_entries64(r, cols), V, precision=_HI)

    return _by_row_blocks(block, rows)


def sqexp_matmat_rect_df64(rows_hi, rows_lo, cols_hi, cols_lo, V):
    """
    Rectangular matmat: ``Y[i, k] = sum_j E(r_i, c_j) V[j, k]`` with
    ``E(a, b) = exp(-0.5 ||a - b||^2)``, rows and columns drawn from
    *different* pre-scaled coordinate pairs. This is the building block of
    the row-sharded multi-device matvec (each device evaluates its row block
    against the full data); the square ``sqexp_matmat_df64`` is the
    ``rows is cols`` case. Returns float64 ``(n_rows, q)``.
    """
    name = "sqexp_matmat_rect_df64"
    _require_x64(name)
    rows = _pair64(rows_hi, rows_lo)
    cols = _pair64(cols_hi, cols_lo)
    V = jnp.asarray(V, jnp.float64)
    _check_block(name, V, cols.shape[0])
    _check_rows(name, rows.shape[0])
    _check_rows(name, cols.shape[0])
    return _rect_matmat(rows, cols, V)


def sqexp_matmat_df64(us_hi, us_lo, V):
    """
    ``Y = E V`` for a block of right-hand sides ``V`` (n, q), with
    ``E_ij = exp(-0.5 ||us_i - us_j||^2)`` evaluated in float64. Returns
    float64 (n, q).
    """
    name = "sqexp_matmat_df64"
    _require_x64(name)
    us = _pair64(us_hi, us_lo)
    V = jnp.asarray(V, jnp.float64)
    _check_block(name, V, us.shape[0])
    _check_rows(name, us.shape[0])
    return _rect_matmat(us, us, V)


def sqexp_matvec_df64(us_hi, us_lo, v):
    """
    ``y = E v`` with ``E_ij = exp(-0.5 ||us_i - us_j||^2)``, where the
    pre-scaled coordinates ``us = x / lengthscales`` are supplied as a
    float32 pair (from ``split_f64``). Returns a float64 vector. Requires
    ``jax_enable_x64``.

    Amplitude and diagonal terms are the caller's job. ``n`` must be a
    multiple of 128 — callers pad with rows whose ``v`` entries are zero.
    """
    return sqexp_matmat_df64(us_hi, us_lo, jnp.reshape(v, (-1, 1)))[:, 0]


def sqexp_matmat_df64_sharded(us_hi, us_lo, V, mesh):
    """
    Row-sharded multi-device variant of ``sqexp_matmat_df64``: data rows
    split over the (1D) ``mesh`` axis, each device evaluating its block of
    ``E V`` against the replicated full data and right-hand sides — no
    cross-device communication beyond the input gather, since every output
    row needs only its own reduction. Output is row-sharded float64
    ``(n, q)``; downstream elementwise solver algebra partitions along the
    same axis. Traceable (usable inside jit).
    """
    from jax import shard_map
    from jax.sharding import PartitionSpec

    axis = mesh.axis_names[0]
    n_dev = mesh.shape[axis]
    n = us_hi.shape[0]
    if n % (n_dev * _PAD) != 0:
        raise ValueError(
            f"[ sqexp_matmat_df64_sharded error ] n ({n}) must split over "
            f"{n_dev} devices into row blocks that are multiples of {_PAD}."
        )
    f = shard_map(
        sqexp_matmat_rect_df64,
        mesh=mesh,
        in_specs=(
            PartitionSpec(axis, None),
            PartitionSpec(axis, None),
            PartitionSpec(None, None),
            PartitionSpec(None, None),
            PartitionSpec(None, None),
        ),
        out_specs=PartitionSpec(axis, None),
        check_vma=False,
    )
    return f(us_hi, us_lo, us_hi, us_lo, V)


# --------------------------------------------------------------------- #
# stored-entries tiers: evaluate the entries once, then every matvec is a
# plain float64 contraction over the stored array
# --------------------------------------------------------------------- #
def stored_entries_tier(n_padded: int, store):
    """The SINGLE storage policy for the df64 tiers — one place to
    retune for a different device memory size. Returns:

    - ``"pair"``  — store the full (E_hi, E_lo) float32 pair
      (8 bytes/entry, ~3.4 GB at n = 20480): matvecs carry NO error
      beyond the pair entries themselves;
    - ``"f32"``   — store the pair-accurate entries rounded to one
      float32 word (4 bytes/entry, ~11.3 GB at n = 53248): iteration
      matvecs carry the 2^-24 entry quantisation and the solver
      refreshes true residuals through the fused kernel;
    - ``None``    — no storage (fused evaluate-per-matvec kernel).

    ``store`` is the user knob: 'auto' picks by size, True demands the
    exact PAIR storage (and raises when it cannot fit, rather than
    silently downgrading the accuracy class or ignoring the request),
    "f32" forces the rounded-f32 tier (any size the array fits — an
    explicit accuracy opt-in), False disables storage.
    """
    if store is False:
        return None
    if store == "f32":
        return "f32"
    if store is True:
        if n_padded > 20480:
            raise ValueError(
                f"[ stored_entries_tier error ] store_entries=True "
                f"requests the exact float32-PAIR entry store, which is "
                f"limited to padded n <= 20480 (8 bytes/entry of device memory); "
                f"got n_padded = {n_padded}. Use store_entries='f32' to "
                f"opt into the quantised single-word tier, or 'auto'/"
                f"False for the policy/fused paths."
            )
        return "pair"
    if n_padded <= 20480:
        return "pair"
    # 53,248 is N = 50k padded to 4096-blocks: 11.3 GB of f32 entries
    if n_padded <= 53248:
        return "f32"
    return None


@jax.jit
def _entries_pair(us):
    def block(r):
        return split_pair(_entries64(r, us))

    return _by_row_blocks(block, us)


def sqexp_entries_df64(us_hi, us_lo):
    """
    Materialise ``E_ij = exp(-0.5 ||us_i - us_j||^2)`` as a float32 PAIR
    ``(E_hi, E_lo)`` of (n, n) device arrays with ``E_hi + E_lo`` the
    float64 entry to ~2^-48 — 8 bytes/entry, so this tier is for moderate
    N (~3.4 GB at n = 20480). Every later ``sqexp_stored_matmat_df64``
    call then skips the entry evaluation.
    """
    name = "sqexp_entries_df64"
    _require_x64(name)
    us = _pair64(us_hi, us_lo)
    _check_rows(name, us.shape[0])
    return _entries_pair(us)


@jax.jit
def _entries_rounded(us):
    return _by_row_blocks(lambda r: _entries64(r, us).astype(jnp.float32), us)


def sqexp_entries_f32(us_hi, us_lo):
    """
    Materialise ``fl32(exp(-0.5 ||us_i - us_j||^2))`` — the float64 entry
    correctly ROUNDED to one float32 word — as an (n, n) device array:
    4 bytes/entry, ~11.3 GB at n = 53,248. Unlike an entry evaluated IN
    float32 (eps32-coherent d^2/exp noise, ~1.2e-5 at large N), the only
    error here is the final 2^-24 quantisation.
    """
    name = "sqexp_entries_f32"
    _require_x64(name)
    us = _pair64(us_hi, us_lo)
    _check_rows(name, us.shape[0])
    return _entries_rounded(us)


@jax.jit
def _stored_pair_matmat(E_hi, E_lo, V):
    def block(eh, el):
        e = eh.astype(jnp.float64) + el.astype(jnp.float64)
        return jnp.dot(e, V, precision=_HI)

    return _by_row_blocks(block, E_hi, E_lo)


def sqexp_stored_matmat_df64(E_hi, E_lo, V):
    """
    ``Y = E V`` from STORED pair entries (``sqexp_entries_df64``): (n, q)
    in, float64 (n, q) out, the same accuracy as ``sqexp_matmat_df64``
    without re-evaluating the entries. Accepts q = 1 columns for the
    matvec case.
    """
    name = "sqexp_stored_matmat_df64"
    _require_x64(name)
    E_hi = jnp.asarray(E_hi, jnp.float32)
    E_lo = jnp.asarray(E_lo, jnp.float32)
    V = jnp.asarray(V, jnp.float64)
    _check_block(name, V, E_hi.shape[1])
    _check_rows(name, E_hi.shape[0])
    return _stored_pair_matmat(E_hi, E_lo, V)


def sqexp_stored_matvec_df64(E_hi, E_lo, v):
    """Single-vector convenience over ``sqexp_stored_matmat_df64``."""
    return sqexp_stored_matmat_df64(E_hi, E_lo, jnp.reshape(v, (-1, 1)))[:, 0]


@jax.jit
def _stored_f32_matmat(E, V):
    def block(e):
        return jnp.dot(e.astype(jnp.float64), V, precision=_HI)

    return _by_row_blocks(block, E)


def sqexp_stored_f32_matmat(E, V):
    """
    ``Y = E V`` from STORED float32 entries (``sqexp_entries_f32``):
    (n, q) in, float64 (n, q) out. The contraction is float64, so the
    operator error is the entries' 2^-24 storage quantisation alone — the
    fast-iteration matvec of the stored-f32 df64 solve tier.
    """
    name = "sqexp_stored_f32_matmat"
    _require_x64(name)
    E = jnp.asarray(E, jnp.float32)
    V = jnp.asarray(V, jnp.float64)
    _check_block(name, V, E.shape[1])
    _check_rows(name, E.shape[0])
    return _stored_f32_matmat(E, V)
