"""Matrix-free GP linear inversion for large parameter grids.

``GpLinearInverter`` (reference: inference/gp/inversion.py:138-155) builds
the dense N x N prior covariance and factorises it — O(N^2) memory and
O(N^3) work, impossible at N ~ 5 x 10^4 parameters. This class solves the
same linear-Gaussian inverse problem matrix-free:

    data-space system   (Sigma + A K A^T) z = y - A mu
    posterior mean      m = mu + K A^T z

The M x M data-space operator is applied as ``A (K (A^T v)) + Sigma v``
with the prior covariance matvec computed in row blocks on the fly (the
same row-block pattern as ``LargeScaleGP`` — no N x N matrix ever
exists), solved with preconditioned conjugate gradients. Posterior
variances come from one BATCHED multi-right-hand-side CG solve over the
requested parameters (each iteration shares a single prior matmul).

Parameter rows (and the model-matrix columns) shard over an optional
device mesh, so N scales with the number of devices.
"""

from warnings import warn

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.scipy.sparse.linalg import cg
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.df64 import split_pair
from ..ops.pairwise import sqexp_covariance
from ..utils.dtypes import default_float

_HI = jax.lax.Precision.HIGHEST


class LargeScaleGpLinearInverter:
    """
    Solve a linear-Gaussian inverse problem ``y = A p + noise`` with a
    GP prior over the parameter field ``p``, for parameter counts far
    beyond dense factorisation.

    :param y: measured data, shape (M,).
    :param y_err: data error standard deviations, shape (M,).
    :param model_matrix: linear forward model ``A``, shape (M, N).
    :param parameter_spatial_positions: positions of the N parameters,
        shape (N, D).
    :param hyperpars: prior-covariance hyperparameters — for the default
        ``SquaredExponential`` that is ``[ln A, ln l_1, ..., ln l_D]``;
        for ``RationalQuadratic``, ``[ln A, ln alpha, ln l_1..l_D]``;
        a ``+ WhiteNoise()`` composition appends its ``ln sigma_w``.
    :param kernel: prior covariance kernel (class or instance) —
        ``SquaredExponential`` (default), ``RationalQuadratic``, or
        either ``+ WhiteNoise()`` (an independent per-parameter prior
        variance term); see ``gp.block_kernels``. Other kernels raise at
        construction. The df64 tier is ``SquaredExponential``-only.
    :param prior_mean: constant prior mean (default 0).
    :param block_size: parameter rows per covariance-block matmul.
    :param cg_tol: conjugate-gradient relative tolerance.
    :param cg_maxiter: conjugate-gradient iteration cap.
    :param solver: "cg" (default), "mixed" or "df64". "mixed" is
        restarted PCG with float64 scalar recurrences (see
        ``LargeScaleGP``) for very small noise where float32 CG's
        recursive residual drifts. "df64" evaluates the whole data-space
        operator to float64 accuracy: the N-dimensional prior-covariance
        contraction through the df64 tier (``ops.df64.sqexp_matvec_df64``)
        on an exact hi/lo input split, the A products as float64 M x N
        matvecs (float32 A products were measured to floor the residual
        at ~2e-5), and float64 CG vectors in compiled chunks. Requires
        ``jax_enable_x64``; with a mesh the prior contraction runs
        row-sharded (``ops.df64.sqexp_matmat_df64_sharded``) across
        devices.
    :param dtype: optional dtype override for the stored arrays and the
        traced solve programs. Defaults to float32 for ``solver="df64"``
        (its precision lives in the float64 operator and CG vectors, not
        the storage) and to the JAX default float
        otherwise.
    :param mesh: optional 1D mesh; parameter rows and the model-matrix
        columns shard over its first axis (the df64 tier's stored-entries
        fast path is single-device and is skipped on a mesh).
    :param store_entries: df64 tier only. ``True``/"auto" store the full
        float32 entry PAIR up to n_padded = 20480 (8 bytes/entry); past
        that, "auto" falls back to the fused evaluate-per-matvec kernel.
        ``"f32"`` (explicit opt-in, up to n_padded = 53248) iterates on
        pair-accurate entries rounded to one float32 word with
        fused-kernel true-residual refreshes — ONLY sound when the data
        noise ``sigma^2`` exceeds the prior's 2^-24 entry-quantisation
        scale (the data-space system's smallest eigenvalue is
        ``sigma_data^2``; refinement stalls above it otherwise —
        ``LargeScaleGP``'s "auto" picks this tier because its regression
        noise floor is its own diagonal, typically far larger).
        ``False``: no storage.
    """

    def __init__(
        self,
        y,
        y_err,
        model_matrix,
        parameter_spatial_positions,
        hyperpars,
        kernel=None,
        prior_mean: float = 0.0,
        block_size: int = 4096,
        cg_tol: float = 1e-6,
        cg_maxiter: int = 1000,
        solver: str = "cg",
        store_entries="auto",
        dtype=None,
        mesh=None,
    ):
        if solver not in ("cg", "mixed", "df64"):
            raise ValueError(
                f"[ LargeScaleGpLinearInverter error ] 'solver' must be "
                f"'cg', 'mixed' or 'df64', but '{solver}' was given."
            )
        from .covariance import SquaredExponential
        from .block_kernels import as_block_kernel

        self._bk = as_block_kernel(
            SquaredExponential if kernel is None else kernel,
            "LargeScaleGpLinearInverter",
        )
        if solver == "df64" and not self._bk.supports_df64:
            raise ValueError(
                f"[ LargeScaleGpLinearInverter error ] solver='df64' is "
                f"implemented for the pure SquaredExponential kernel only "
                f"(the df64 tier's entry evaluation is kernel-"
                f"specific); got {self._bk.name}. Use solver='cg' or "
                f"'mixed' for this kernel."
            )
        if store_entries not in ("auto", True, False, "f32"):
            raise ValueError(
                f"[ LargeScaleGpLinearInverter error ] 'store_entries' "
                f"must be 'auto', True, False or 'f32', but "
                f"{store_entries!r} was given."
            )
        if store_entries in (True, "f32") and solver != "df64":
            raise ValueError(
                "[ LargeScaleGpLinearInverter error ] store_entries "
                "is a df64-tier option; use solver='df64' or drop the "
                "flag."
            )
        self.store_entries = store_entries
        if solver == "df64":
            if not jax.config.read("jax_enable_x64"):
                raise ValueError(
                    "[ LargeScaleGpLinearInverter error ] solver='df64' "
                    "requires jax.config.update('jax_enable_x64', True)."
                )
            if mesh is not None and store_entries in (True, "f32"):
                raise ValueError(
                    "[ LargeScaleGpLinearInverter error ] "
                    "store_entries is single-device (the stored entries "
                    "live in one device's memory); with a mesh the df64 "
                    "tier runs the row-sharded matvec — drop the flag."
                )
        self.solver = solver
        self._mesh = mesh
        if dtype is None:
            # df64 carries its precision in the float64 matvec, the f64
            # A products and the float64 CG vectors; the stored arrays
            # and traced fallback programs stay float32 — float64 storage
            # under jax_enable_x64 (mandatory for df64) would silently
            # run every traced kernel-block matmul in f64
            dtype = jnp.float32 if solver == "df64" else default_float()
        else:
            dtype = jnp.dtype(dtype)
            if dtype == jnp.float64 and not jax.config.read("jax_enable_x64"):
                raise ValueError(
                    "[ LargeScaleGpLinearInverter error ] dtype='float64' "
                    "requires jax.config.update('jax_enable_x64', True) "
                    "before any arrays are created."
                )
        y = np.asarray(y, dtype=float).squeeze()
        y_err = np.asarray(y_err, dtype=float).squeeze()
        A = np.asarray(model_matrix, dtype=float)
        x = np.atleast_2d(np.asarray(parameter_spatial_positions, dtype=float))
        if A.ndim != 2 or A.shape[0] != y.size or A.shape[1] != x.shape[0]:
            raise ValueError(
                f"[ LargeScaleGpLinearInverter error ] shapes are "
                f"inconsistent: A {A.shape}, y {y.shape}, positions {x.shape}"
            )
        if (y_err <= 0).any():
            raise ValueError(
                "[ LargeScaleGpLinearInverter error ] all 'y_err' values "
                "must be positive"
            )
        self.M, self.n_parameters = A.shape
        self.n_dimensions = x.shape[1]
        hyperpars = np.asarray(hyperpars, dtype=float)
        expected = self._bk.n_params(self.n_dimensions)
        if hyperpars.size != expected:
            raise ValueError(
                f"[ LargeScaleGpLinearInverter error ] kernel "
                f"{self._bk.name} over {self.n_dimensions}-dimensional "
                f"positions takes {expected} hyperparameters, but "
                f"{hyperpars.size} were given."
            )
        self.hyperpars = hyperpars
        self.prior_mean = float(prior_mean)

        # pad parameter rows to a block multiple; padded rows have zero
        # model-matrix columns, so they never influence the data space
        self.block_size = int(block_size)
        n_pad = -(-self.n_parameters // self.block_size) * self.block_size
        extra = n_pad - self.n_parameters
        if extra > 0:
            x = np.concatenate(
                [x, np.repeat(x.mean(axis=0, keepdims=True), extra, axis=0)]
            )
            A = np.concatenate([A, np.zeros((self.M, extra))], axis=1)
        self._n_padded = n_pad

        # float64 host copies for the df64 solve path (rhs and scaled
        # coordinates must not be floored at eps32 by the device cast)
        self._y_host = y
        self._sig_host = y_err**2
        self._A_row_sums = A.sum(axis=1)

        self._x = jnp.asarray(x, dtype)
        self._A = jnp.asarray(A, dtype)
        self._y = jnp.asarray(y, dtype)
        self._sig = jnp.asarray(y_err**2, dtype)
        self._theta = jnp.asarray(hyperpars, dtype)

        if mesh is not None:
            axis = mesh.axis_names[0]
            self._x = jax.device_put(
                self._x, NamedSharding(mesh, P(axis, None))
            )
            self._A = jax.device_put(
                self._A, NamedSharding(mesh, P(None, axis))
            )

        if solver == "df64":
            self._prepare_df64(x)
        self._build_compiled(cg_tol, cg_maxiter)
        self.z = self._solve_data_space()
        if solver == "df64":
            # full-precision data-space solution kept; float32 cast feeds
            # the compiled prediction programs
            self.z64 = np.asarray(self.z, np.float64)
            self.z = jnp.asarray(self.z64, dtype)
        self.posterior_mean_field = None

    def _prepare_df64(self, x_padded):
        """Pre-split the scaled parameter positions into a float32 pair
        (host float64; hyperparameters are fixed for the solve)."""
        from ..ops.df64 import split_f64, _PAD

        if self._n_padded % _PAD != 0:
            raise ValueError(
                f"[ LargeScaleGpLinearInverter error ] solver='df64' "
                f"needs the padded parameter count to be a multiple of "
                f"{_PAD}; use a block_size that is a multiple of {_PAD}."
            )
        if self._mesh is not None:
            from ..ops.df64 import _PAD

            n_dev = self._mesh.shape[self._mesh.axis_names[0]]
            if self._n_padded % (n_dev * _PAD) != 0:
                raise ValueError(
                    f"[ LargeScaleGpLinearInverter error ] solver='df64' "
                    f"on a {n_dev}-device mesh needs the padded parameter "
                    f"count ({self._n_padded}) to split into per-device "
                    f"blocks that are multiples of {_PAD}; adjust "
                    f"block_size."
                )
        ls64 = np.exp(np.asarray(self.hyperpars[1:], np.float64))
        self._x_pad_host = np.asarray(x_padded, np.float64)
        uh, ul = split_f64(self._x_pad_host / ls64[None, :])
        self._us_hi = jnp.asarray(uh)
        self._us_lo = jnp.asarray(ul)
        self._sig64 = jnp.asarray(self._sig_host, jnp.float64)
        self._A64 = None  # set in _build_compiled (needs the padded A)
        self._entries = None
        self._entries_f32 = None
        if self._mesh is not None:
            # the mesh path runs the row-sharded matvec; a stored (n, n)
            # entry pair lives in one device's memory
            return
        from ..ops.df64 import stored_entries_tier

        tier = stored_entries_tier(self._n_padded, self.store_entries)
        if tier == "f32" and self.store_entries == "auto":
            # "auto" never picks the f32 tier HERE (unlike LargeScaleGP):
            # the data-space system's smallest eigenvalue is the DATA
            # noise sigma^2 — usually far below the GP regression noise —
            # and iterative refinement only contracts while the prior's
            # 2^-24 entry quantisation stays below it (measured: at
            # sigma_data = 1e-3 the f32 tier stalls at residual ~2e-3
            # where the fused tier reaches 1e-7). Opt in with
            # store_entries="f32" for moderate-noise problems.
            tier = None
        if tier == "pair":
            from ..ops.df64 import sqexp_entries_df64

            self._entries = sqexp_entries_df64(self._us_hi, self._us_lo)
        elif tier == "f32":
            # pair-accurate entries rounded to one float32 word: CG
            # iterates on them and the solver's true-residual refreshes
            # anchor on the fused pair kernel (iterative refinement —
            # see LargeScaleGP and ops/solvers.py::Df64MultiSolver)
            from ..ops.df64 import sqexp_entries_f32

            self._entries_f32 = sqexp_entries_f32(self._us_hi, self._us_lo)

    def _df64_op_args(self):
        """Runtime operands of the double-float prior operator: the stored
        entry pair when materialised, else the scaled-coordinate pair.
        Threaded through the solver as arguments on every dispatch — a
        bound method closing over an (n, n) device array would embed it
        in the compiled chunk's HLO module as a constant."""
        if self._entries is not None:
            return self._entries
        return (self._us_hi, self._us_lo)

    def _prior_matmat64(self, V32, op_a, op_b):
        """``E V`` through the stored entry pair, the row-sharded mesh
        kernel, or the single-device fused kernel — the branch is static
        at trace time; ``(op_a, op_b)`` carries the branch's arrays."""
        if self._entries is not None:
            from ..ops.df64 import sqexp_stored_matmat_df64

            return sqexp_stored_matmat_df64(op_a, op_b, V32)
        if self._mesh is not None:
            from ..ops.df64 import sqexp_matmat_df64_sharded

            return sqexp_matmat_df64_sharded(op_a, op_b, V32, self._mesh)
        from ..ops.df64 import sqexp_matmat_df64

        return sqexp_matmat_df64(op_a, op_b, V32)

    def _prior_apply_split64(self, P64, op_a, op_b):
        """``K P`` for a float64 (n, q) block, through ONE df64 matmat on
        the exact hi/lo split of ``P`` (the hi and lo columns ride
        together, so the entries are evaluated once)."""
        q = P64.shape[1]
        Ph, Pl = split_pair(P64)
        KP = self._prior_matmat64(
            jnp.concatenate([Ph, Pl], axis=1), op_a, op_b
        )
        amp2 = np.exp(2.0 * float(self.hyperpars[0]))
        return amp2 * (KP[:, :q] + KP[:, q:])

    def _data_matvec64(self, v32, A64, op_a, op_b):
        """Double-float data-space matvec ``(Sigma + A K A^T) v``: the
        N-dimensional prior-covariance contraction runs through the df64
        tier on an exact hi/lo split of its float64 input, and the A
        products are float64 M x N matVECs (float32 A products were
        measured to floor the data-space residual at ~2e-5: their
        rounding is operator-internal noise that the solver cannot
        correct)."""
        f64 = jnp.float64
        v64 = v32.astype(f64)
        p64 = jnp.dot(A64.T, v64, precision=_HI)
        Kp = self._prior_apply_split64(p64[:, None], op_a, op_b)[:, 0]
        AKp = jnp.dot(A64, Kp, precision=_HI)
        return self._sig64 * v64 + AKp

    def _data_matmat64(self, V32, A64, op_a, op_b):
        """Multi-RHS double-float data-space matmat ``(Sigma + A K A^T) V``
        — the batched-variance counterpart of ``_data_matvec64`` (all
        hi/lo columns of the block share one entry evaluation)."""
        f64 = jnp.float64
        V64 = V32.astype(f64)
        P64 = jnp.dot(A64.T, V64, precision=_HI)
        KP = self._prior_apply_split64(P64, op_a, op_b)
        AKP = jnp.dot(A64, KP, precision=_HI)
        return self._sig64[:, None] * V64 + AKP

    def _prior_apply_split64_fast(self, P64, E):
        """``K P`` through the STORED float32 entries (fast-iteration
        path of the stored-f32 tier): operator error = the 2^-24 entry
        quantisation; the contraction itself is pair-exact."""
        from ..ops.df64 import sqexp_stored_f32_matmat

        q = P64.shape[1]
        Ph, Pl = split_pair(P64)
        KP = sqexp_stored_f32_matmat(E, jnp.concatenate([Ph, Pl], axis=1))
        amp2 = np.exp(2.0 * float(self.hyperpars[0]))
        return amp2 * (KP[:, :q] + KP[:, q:])

    def _data_matvec64_fast(self, v32, A64, E):
        """Fast-iteration data-space matvec for the stored-f32 tier
        (``Df64Solver`` iterations; refreshes anchor on
        ``_data_matvec64``)."""
        return self._data_matmat64_fast(v32.reshape(-1, 1), A64, E)[:, 0]

    def _data_matmat64_fast(self, V32, A64, E):
        f64 = jnp.float64
        V64 = V32.astype(f64)
        P64 = jnp.dot(A64.T, V64, precision=_HI)
        KP = self._prior_apply_split64_fast(P64, E)
        AKP = jnp.dot(A64, KP, precision=_HI)
        return self._sig64[:, None] * V64 + AKP

    def _df64_fast_kwargs(self, kind: str):
        """Constructor kwargs wiring the stored-f32 fast iterations into
        a Df64Solver ('matvec') or Df64MultiSolver ('matmat'); empty
        when the tier is not active. The stored entries travel as a
        runtime operand (compile-payload trap)."""
        if self._entries_f32 is None:
            return {}
        if kind == "matvec":
            return {
                "matvec_fast": self._data_matvec64_fast,
                "matvec_fast_args": (self._A64, self._entries_f32),
            }
        return {
            "matmat_fast": self._data_matmat64_fast,
            "matmat_fast_args": (self._A64, self._entries_f32),
        }

    def _rhs64(self) -> np.ndarray:
        return self._y_host - self.prior_mean * self._A_row_sums

    def residual_norm_f64(self) -> float:
        """Relative residual of the data-space solve, evaluated through
        the double-float matvec (solver='df64' instances only)."""
        if self.solver != "df64":
            raise ValueError(
                "[ LargeScaleGpLinearInverter error ] residual_norm_f64 "
                "requires solver='df64'."
            )
        z64 = getattr(self, "z64", None)
        if z64 is None:
            z64 = np.asarray(self.z, np.float64)
        zh = z64.astype(np.float32)
        zl = (z64 - zh.astype(np.float64)).astype(np.float32)
        op = self._df64_op_args()
        Az = np.asarray(
            self._data_matvec64(jnp.asarray(zh), self._A64, *op)
        ) + np.asarray(self._data_matvec64(jnp.asarray(zl), self._A64, *op))
        rhs = self._rhs64()
        return float(
            np.linalg.norm(rhs - Az) / max(np.linalg.norm(rhs), 1e-300)
        )

    def _build_compiled(self, cg_tol, cg_maxiter):
        """All compiled programs take the model matrix, positions and
        noise as RUNTIME arguments — closed-over (M, N) constants would be
        baked into every HLO (the compile-payload trap documented in
        large_scale.py)."""
        theta = self._theta
        n_pad, block = self._n_padded, self.block_size
        n_blocks = n_pad // block

        def k_matvec(x, v):
            """Prior-covariance action ``K @ v`` in row blocks (never
            dense K), for a vector (n_pad,) or a column block (n_pad, q)
            — one blocked matmul serves every column at once. A
            WhiteNoise prior component acts diagonally."""
            x_blocks = x.reshape(n_blocks, block, -1)

            def one_block(xb):
                return jnp.dot(
                    self._bk.rows(xb, x, theta), v, precision=_HI
                )

            Kv = lax.map(one_block, x_blocks).reshape(
                (n_pad,) + v.shape[1:]
            )
            return Kv + self._bk.noise_variance(theta) * v

        def data_matvec(A, x, sig, v):
            """(Sigma + A K A^T) @ v."""
            p = jnp.dot(A.T, v, precision=_HI)
            Kp = k_matvec(x, p)
            return sig * v + jnp.dot(A, Kp, precision=_HI)

        use_mixed = self.solver == "mixed"
        use_df64 = self.solver == "df64"

        def solve_data(A, x, sig, rhs):
            # Jacobi preconditioner on the noise diagonal. For the df64
            # solver this traced float32 path serves only the compiled
            # prediction programs (posterior variances); the data-space
            # training solve goes through the host-driven Df64Solver.
            if use_mixed or use_df64:
                from ..ops.solvers import mixed_pcg

                sol, _ = mixed_pcg(
                    lambda v: data_matvec(A, x, sig, v),
                    rhs,
                    M=lambda v: v / sig,
                    tol=cg_tol,
                    maxiter=cg_maxiter,
                )
            else:
                sol, _ = cg(
                    lambda v: data_matvec(A, x, sig, v),
                    rhs,
                    tol=cg_tol,
                    maxiter=cg_maxiter,
                    M=lambda v: v / sig,
                )
            return sol

        def solve_data_space(A, x, sig, y):
            rhs = y - self.prior_mean * A.sum(axis=1)
            return solve_data(A, x, sig, rhs)

        solve_ds_jit = jax.jit(solve_data_space)
        solve_jit = jax.jit(solve_data)
        matvec_jit = jax.jit(data_matvec)
        args = lambda: (self._A, self._x, self._sig)
        self._solve_data = lambda rhs: solve_jit(*args(), rhs)
        self._data_matvec = lambda v: matvec_jit(*args(), v)
        if use_df64:
            from ..ops.solvers import Df64Solver

            self._A64 = jnp.asarray(np.asarray(self._A), jnp.float64)
            # the stored-f32 tier keeps FULL-length chunks here (unlike
            # LargeScaleGP._df64_chunk): the data-space solve has only a
            # diagonal preconditioner, so real Krylov depth is needed —
            # inner-CG breakdowns at the quantisation depth end the
            # chunk early and the host loop resumes from the refreshed
            # residual (ops.solvers.Df64MultiSolver.solve)
            solver = Df64Solver(
                self._data_matvec64,
                M=lambda v, sig: v / sig,
                M_args=(self._sig,),
                matvec_args=(self._A64, *self._df64_op_args()),
                **self._df64_fast_kwargs("matvec"),
            )
            def solve_ds_checked():
                sol, info = solver.solve(
                    jnp.asarray(self._rhs64()),
                    tol=cg_tol,
                    maxiter=cg_maxiter,
                )
                if info != 0:
                    hint = (
                        " The stored-f32 entry tier is active: its "
                        "2^-24 quantisation may exceed the data noise "
                        "scale — retry with store_entries=False."
                        if self._entries_f32 is not None
                        else " Raise cg_maxiter or loosen cg_tol."
                    )
                    warn(
                        f"[ LargeScaleGpLinearInverter warning ] the "
                        f"df64 data-space solve stopped after {info} "
                        f"iterations above the requested tolerance "
                        f"{cg_tol:.1e}; the best iterate is returned "
                        f"but may be inaccurate.{hint}"
                    )
                return sol

            self._solve_data_space = solve_ds_checked
        else:
            self._solve_data_space = lambda: solve_ds_jit(*args(), self._y)

        def mean_field(A, x, z):
            return self.prior_mean + k_matvec(
                x, jnp.dot(A.T, z, precision=_HI)
            )

        mean_jit = jax.jit(mean_field)
        self._mean_field = lambda: mean_jit(self._A, self._x, self.z)

        # column blocks ride through the same blocked contraction
        k_matvec_multi = k_matvec

        def variances(A, x, sig, idx):
            """Posterior variances for selected parameter indices: one
            BATCHED data-space solve — every CG iteration applies one
            shared prior matmul to all requested indices at once."""
            from ..ops.solvers import pcg_multi

            x_sel = x[idx]
            K_sx = self._bk.rows(x_sel, x, theta)
            # a WhiteNoise prior component contributes its variance on
            # the (selected-parameter, same-parameter) diagonal entries
            K_sx = K_sx.at[
                jnp.arange(idx.shape[0]), idx
            ].add(self._bk.noise_variance(theta))
            AK = jnp.dot(A, K_sx.T, precision=_HI)  # (M, n_sel)

            def data_matvec_multi(V):
                P = jnp.dot(A.T, V, precision=_HI)
                KP = k_matvec_multi(x, P)
                return (sig * V.T).T + jnp.dot(A, KP, precision=_HI)

            sols, _ = pcg_multi(
                data_matvec_multi,
                AK,
                M=lambda V: V / sig[:, None],
                tol=cg_tol,
                maxiter=cg_maxiter,
            )
            quad = jnp.sum(AK * sols, axis=0)
            prior_var = self._bk.amp2(theta) + self._bk.noise_variance(
                theta
            )
            return prior_var - quad

        var_jit = jax.jit(variances)
        self._variances = lambda idx: var_jit(*args(), idx)
        if use_df64:
            # the f32 prediction paths would floor far above the df64
            # solve's accuracy (kernel-entry noise ~1e-5 on the mean
            # contraction; the amp^2 - quad variance cancellation reaches
            # sigma^2 scale at small noise) — route both through the
            # df64 tier and the float64 solution
            self._mean_field = self._mean_field_df64
            self._variances = self._variances_df64
            self._cg_tol, self._cg_maxiter = cg_tol, cg_maxiter

    # data-space variance solves per column block: each block column
    # carries a hi/lo pair through the matmat
    _DF64_VAR_COLS = 4

    def _k_rows_host64(self, idx) -> np.ndarray:
        """Float64 host prior-covariance rows ``K(x_sel, x_padded)`` —
        ``large_scale.sqexp_rows_host64`` carries the numerical rationale.
        Padded columns hold kernel values but die through the model
        matrix's zero columns downstream."""
        from .large_scale import sqexp_rows_host64

        sel = self._x_pad_host[np.asarray(idx, dtype=int)]
        return sqexp_rows_host64(sel, self._x_pad_host, self.hyperpars)

    def _mean_field_df64(self) -> np.ndarray:
        """Posterior mean field at float64: ``mu + K A^T z64`` with the
        prior contraction through ONE df64 matmat on the exact
        hi/lo split of ``A^T z64`` (the f32 traced path's kernel-entry
        noise ~1e-5 would bury the data-space solve's ~1e-10 accuracy)."""
        A64h = np.asarray(self._A64, np.float64)
        w64 = A64h.T @ self.z64
        Kw = np.asarray(
            self._prior_apply_split64(
                jnp.asarray(w64)[:, None], *self._df64_op_args()
            )[:, 0]
        )
        return self.prior_mean + Kw

    def _variances_df64(self, indices) -> np.ndarray:
        """Posterior variances for the df64 tier at float64 end to end:
        host f64 cross-covariance rows, batched double-float data-space
        solves, and the ``amp^2 - quad`` subtraction (which cancels to
        sigma^2 scale at small noise — beyond float32 reach) in host f64."""
        import warnings

        from ..ops.solvers import Df64MultiSolver

        idx = np.atleast_1d(np.asarray(indices, dtype=int))
        amp2 = float(np.exp(2.0 * self.hyperpars[0]))
        A64h = np.asarray(self._A64, np.float64)

        solver = getattr(self, "_df64_var_solver", None)
        if solver is None:
            # the stored-f32 tier keeps full-length chunks (diagonal-only
            # preconditioner — see the training-solver construction)
            solver = Df64MultiSolver(
                self._data_matmat64,
                M=lambda R, sig: R / sig[:, None],
                M_args=(self._sig64,),
                matmat_args=(self._A64, *self._df64_op_args()),
                **self._df64_fast_kwargs("matmat"),
            )
            self._df64_var_solver = solver

        qc = self._DF64_VAR_COLS
        m = idx.shape[0]
        quad = np.empty(m)
        for start in range(0, m, qc):
            stop = min(start + qc, m)
            K_sx = self._k_rows_host64(idx[start:stop])   # (b, n_pad)
            AK = A64h @ K_sx.T                            # (M, b) f64
            # fixed-width blocks keep ONE compiled chunk program across
            # all query counts (zero columns converge instantly)
            B = np.zeros((self.M, qc))
            B[:, : stop - start] = AK
            # 1e-8 relative is ample for a variance quadratic form: a
            # tighter data-space tol
            # would spin to maxiter without gaining accuracy
            X, info = solver.solve(
                jnp.asarray(B),
                tol=max(self._cg_tol, 1e-8),
                maxiter=self._cg_maxiter,
            )
            if info != 0:
                warnings.warn(
                    f"LargeScaleGpLinearInverter variance solve for "
                    f"parameter indices {idx[start:stop].tolist()} stopped "
                    f"at iteration {info} without reaching "
                    f"tol={self._cg_tol:.1e}; raise cg_maxiter."
                )
            quad[start:stop] = np.einsum(
                "mi,mi->i", AK, np.asarray(X, np.float64)[:, : stop - start]
            )
        return amp2 - quad

    # ------------------------------------------------------------------ #
    # hyperparameter fitting
    # ------------------------------------------------------------------ #
    def _data_matmat_live(self, theta, V):
        """``(Sigma + A K(theta) A^T) V`` with LIVE hyperparameters, for
        a data-space column block (M, q) — the same blocked prior
        contraction as the solve path, differentiable through ``theta``
        for the stochastic-LML fit."""
        A, x, sig = self._A, self._x, self._sig
        n_pad, block = self._n_padded, self.block_size
        P = jnp.dot(A.T, V, precision=_HI)
        x_blocks = x.reshape(n_pad // block, block, -1)

        def one_block(xb):
            return jnp.dot(self._bk.rows(xb, x, theta), P, precision=_HI)

        KP = lax.map(one_block, x_blocks).reshape((n_pad,) + P.shape[1:])
        KP = KP + self._bk.noise_variance(theta) * P
        return (sig * V.T).T + jnp.dot(A, KP, precision=_HI)

    def fit(
        self,
        n_steps: int = 40,
        learning_rate: float = 0.05,
        n_probes: int = 8,
        fit_tol: float = 1e-3,
        fit_maxiter: int = 150,
        seed: int = 0,
        verbose: bool = False,
    ):
        """
        Select prior hyperparameters by maximising the DATA-SPACE
        marginal likelihood without ever factorising the M x M system —
        the large-N counterpart of the reference's dense
        ``GpLinearInverter`` fit (reference: inference/gp/inversion.py:
        174-249, which needs ``chol(A K A^T + Sigma)`` per objective
        evaluation). Same machinery as ``LargeScaleGP.fit``: per Adam
        step ONE batched multi-RHS CG computes ``z = S^-1 r`` and
        ``u_i = S^-1 zeta_i`` for Rademacher probes, then the gradient of

            L = -0.5 r^T S^-1 r - 0.5 logdet S,   S = Sigma + A K(th) A^T

        assembles by autodiff of the blocked live-theta products with
        ``z, u`` held fixed (the Sigma term is theta-independent and
        drops out of the gradient). Returns the optimised prior
        hyperparameter vector without mutating this instance —
        construct a new inverter with the result, matching
        ``LargeScaleGP.fit``'s contract. A step whose inner CG stops
        above ``max(10 * fit_tol, 0.05)`` relative residual warns that
        the stochastic gradient is substantially biased.
        """
        if n_probes < 1:
            raise ValueError(
                "LargeScaleGpLinearInverter.fit requires n_probes >= 1"
            )
        wd = self._x.dtype
        m = self._A.shape[0]
        rng = np.random.default_rng(seed)
        probes = jnp.asarray(rng.choice([-1.0, 1.0], size=(m, n_probes)), wd)
        rhs0 = jnp.asarray(self._rhs64(), wd)

        fit_step = self._get_fit_step(float(fit_tol), int(fit_maxiter))
        theta = jnp.asarray(self.hyperpars, wd)
        adam = (jnp.zeros_like(theta), jnp.zeros_like(theta))
        warned = False
        for step in range(int(n_steps)):
            theta, adam, g, data_fit, rel_resid = fit_step(
                theta, adam, jnp.asarray(step + 1, wd),
                jnp.asarray(learning_rate, wd), rhs0, probes,
            )
            if not warned and float(rel_resid) > max(10.0 * fit_tol, 0.05):
                import warnings

                warnings.warn(
                    f"LargeScaleGpLinearInverter.fit: inner CG stopped at "
                    f"relative residual {float(rel_resid):.2e} on step "
                    f"{step + 1} — the stochastic gradient is "
                    f"substantially biased; increase fit_maxiter"
                )
                warned = True
            if verbose:
                print(
                    f"  [ LargeScaleGpLinearInverter.fit step "
                    f"{step + 1}/{n_steps}: |grad| "
                    f"{float(jnp.linalg.norm(g)):.3e}, data-fit "
                    f"{float(data_fit):.4f}, CG resid "
                    f"{float(rel_resid):.1e}, theta "
                    f"{np.asarray(theta).round(3)} ]",
                    flush=True,
                )
        return np.asarray(theta, float)

    def _get_fit_step(self, fit_tol, fit_maxiter):
        """One jitted Adam step of the stochastic data-space LML fit,
        cached per (tol, maxiter) — see ``LargeScaleGP._get_fit_step``."""
        cache = getattr(self, "_fit_step_cache", None)
        if cache is None:
            cache = self._fit_step_cache = {}
        key = (fit_tol, fit_maxiter)
        if key in cache:
            return cache[key]

        from ..ops.solvers import pcg_multi

        sig = self._sig

        @jax.jit
        def fit_step(theta, adam, t, lr, rhs, Z):
            th0 = lax.stop_gradient(theta)
            B = jnp.concatenate([rhs[:, None], Z], axis=1)
            Sol, _ = pcg_multi(
                lambda V: self._data_matmat_live(th0, V),
                B,
                M=lambda V: V / sig[:, None],
                tol=fit_tol,
                maxiter=fit_maxiter,
            )
            Sol = lax.stop_gradient(Sol)
            z, U = Sol[:, :1], Sol[:, 1:]
            R = B - self._data_matmat_live(th0, Sol)
            rel_resid = jnp.sqrt(
                jnp.max(jnp.sum(R * R, axis=0) / jnp.sum(B * B, axis=0))
            )

            def surrogate(th):
                SW = self._data_matmat_live(
                    th, jnp.concatenate([z, Z], axis=1)
                )
                s_data = -0.5 * jnp.sum(z[:, 0] * SW[:, 0])
                s_trace = 0.5 * jnp.mean(jnp.sum(U * SW[:, 1:], axis=0))
                return s_data + s_trace

            g = jax.grad(surrogate)(theta)
            mo, v = adam
            b1, b2, eps = 0.9, 0.999, 1e-8
            mo = b1 * mo + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            m_hat = mo / (1.0 - b1**t)
            v_hat = v / (1.0 - b2**t)
            theta = theta - lr * m_hat / (jnp.sqrt(v_hat) + eps)
            data_fit = -0.5 * jnp.sum(z[:, 0] * rhs)
            return theta, (mo, v), g, data_fit, rel_resid

        cache[key] = fit_step
        return fit_step

    # ------------------------------------------------------------------ #
    # results
    # ------------------------------------------------------------------ #
    def calculate_posterior_mean(self) -> np.ndarray:
        """Posterior mean of the parameter field, shape (N,)."""
        if self.posterior_mean_field is None:
            self.posterior_mean_field = np.asarray(self._mean_field())[
                : self.n_parameters
            ]
        return self.posterior_mean_field

    def posterior_variances(self, indices) -> np.ndarray:
        """Posterior variances at the given parameter indices (one CG
        solve each — request the points you need, not all N)."""
        idx = jnp.asarray(np.asarray(indices, dtype=int))
        return np.asarray(self._variances(idx))

    def predict_data(self) -> np.ndarray:
        """The forward model applied to the posterior mean, shape (M,)."""
        m = jnp.asarray(self.calculate_posterior_mean())
        return np.asarray(
            jnp.dot(self._A[:, : self.n_parameters], m, precision=_HI)
        )

    def residual_norm(self) -> float:
        """Relative residual of the data-space solve."""
        rhs = self._y - self.prior_mean * self._A.sum(axis=1)
        r = self._data_matvec(self.z) - rhs
        return float(jnp.linalg.norm(r) / jnp.linalg.norm(rhs))
