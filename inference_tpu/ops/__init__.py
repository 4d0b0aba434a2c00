"""Low-level compute ops: pairwise-distance / covariance assembly
(``pairwise``), device linear-algebra helpers (``linalg``), the float64
covariance matvecs and entry stores of the df64 tier (``df64``), and the
mixed-precision conjugate-gradient family (``solvers``)."""

from .pairwise import scaled_sq_distances, sqexp_covariance
from .linalg import add_diagonal, identity_like
from .solvers import (
    mixed_pcg,
    pcg_multi,
    df64_pcg,
    Df64Solver,
    Df64MultiSolver,
)
from .df64 import (
    sqexp_matvec_df64,
    sqexp_matmat_df64,
    sqexp_matmat_rect_df64,
    sqexp_matmat_df64_sharded,
    sqexp_entries_df64,
    sqexp_entries_f32,
    sqexp_stored_matvec_df64,
    sqexp_stored_matmat_df64,
    sqexp_stored_f32_matmat,
    stored_entries_tier,
    split_f64,
)

__all__ = [
    "scaled_sq_distances",
    "sqexp_covariance",
    "add_diagonal",
    "identity_like",
    "mixed_pcg",
    "pcg_multi",
    "df64_pcg",
    "Df64Solver",
    "Df64MultiSolver",
    "sqexp_matvec_df64",
    "sqexp_matmat_df64",
    "sqexp_matmat_rect_df64",
    "sqexp_matmat_df64_sharded",
    "sqexp_entries_df64",
    "sqexp_entries_f32",
    "sqexp_stored_matvec_df64",
    "sqexp_stored_matmat_df64",
    "sqexp_stored_f32_matmat",
    "stored_entries_tier",
    "split_f64",
]
