"""Matrix-free Gaussian-process regression for very large datasets.

The exact `GpRegressor` factorises the N x N covariance (O(N^2) memory,
O(N^3) flops) — beyond a few 10^4 points that no longer fits one device.
``LargeScaleGP`` solves the same linear systems **matrix-free**: the kernel
matrix is never materialised; its action ``(K + sigma^2 I) v`` is computed
in row blocks (each block one kernel-block matmul, SURVEY.md
section 7 item 6 — the reference's N x N x D precompute at these sizes is a
hard memory wall, reference: covariance.py:218-219), and the training
solve uses conjugate gradients.

Sharding: the data rows and the solve vectors carry a ``NamedSharding``
when a mesh is given, so XLA partitions each blocked matvec across devices
and inserts the psum for the row-block products — the same program scales
from one device to several.
"""

from warnings import warn

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

# float32 matmuls may run at reduced precision (TF32 on the GPU);
# conjugate gradients cannot tolerate that matvec noise, so every
# solve-critical matmul here requests full float32 precision
_HI = jax.lax.Precision.HIGHEST
from jax.scipy.sparse.linalg import cg
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.pairwise import sqexp_covariance
from ..ops.solvers import DF64_RESTART_EVERY
from ..utils.dtypes import default_float
from .block_kernels import SqExpBlock, as_block_kernel
from .covariance import SquaredExponential


def woodbury_apply(V, U, dinv, core, *, core_chol, out_dtype=None):
    """``(D + U U^T)^{-1} V`` for a vector or (n, q) block ``V``, via the
    Woodbury identity — THE single application of the low-rank
    preconditioner; every solve/variance/fit path in this module routes
    through it so the delicate parts (application dtype, core handling,
    the cancelling subtraction) cannot drift between copies.

    ``U``: (n, m) low-rank factor; ``dinv``: elementwise ``1/diag(D)``
    in the APPLICATION dtype (float64 under x64 for the small-noise
    regimes — the core's condition reaches ``amp^2 N / sigma^2`` and the
    subtraction cancels ~log10(kappa) digits, so an f32 application is
    garbage beyond kappa ~ 1e7); ``core``: the lower Cholesky factor of
    ``C = I + U^T D^{-1} U`` (``core_chol=True``, applied by cho_solve)
    or its explicit inverse (``core_chol=False``, applied by matmul —
    the all-matmul form the f64 paths use)."""
    vec = V.ndim == 1
    W = (V[:, None] if vec else V).astype(dinv.dtype) * dinv[:, None]
    U_ = U.astype(dinv.dtype)
    t = jnp.dot(U_.T, W, precision=_HI)
    if core_chol:
        t = jax.scipy.linalg.cho_solve((core, True), t)
    else:
        t = jnp.dot(core, t, precision=_HI)
    out = W - dinv[:, None] * jnp.dot(U_, t, precision=_HI)
    if out_dtype is not None:
        out = out.astype(out_dtype)
    return out[:, 0] if vec else out


def sqexp_rows_host64(q, x, hyperpars):
    """Float64 host squared-exponential covariance rows ``K(q, x)`` via
    the sq-norm + matmul distance form — no ``(m, n, d)`` displacement
    broadcast, so the peak temporary is the (m, n) result itself. The
    matmul form's cancellation is harmless HERE because this runs in host
    float64: the d2 error is ~|q/ls|^2 eps64 ~ 1e-14 on realistic scaled
    domains (on the f32 DEVICE the same trick loses ~2e-1 and is exactly
    what ops/df64.py exists to avoid). THE single host-f64 kernel-row
    evaluation — ``LargeScaleGP`` and ``LargeScaleGpLinearInverter`` both
    route their df64-tier prediction paths through it."""
    h = np.asarray(hyperpars, np.float64)
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


class LargeScaleGP:
    """
    GP regression with matrix-free training solves, for datasets beyond
    the reach of dense factorisation. Hyperparameters can be selected at
    this scale too: ``fit()`` maximises the marginal likelihood with
    Hutchinson-trace stochastic gradients through batched multi-RHS CG —
    no dense K at any point.

    :param x: data positions, shape (n_points, n_dims).
    :param y: data values, shape (n_points,).
    :param y_err: per-point Gaussian error standard deviations.
    :param hyperpars: the kernel's hyperparameter vector — for the
        default ``SquaredExponential`` that is ``[ln A, ln l_1..l_D]``
        (as ``GpRegressor`` with a known constant mean); for
        ``RationalQuadratic`` it is ``[ln A, ln alpha, ln l_1..l_D]``;
        a ``+ WhiteNoise()`` composition appends its ``ln sigma_w`` in
        the dense composite's slice order.
    :param kernel: covariance kernel (class or instance) —
        ``SquaredExponential`` (default), ``RationalQuadratic``, or
        either ``+ WhiteNoise()``; see ``gp.block_kernels``. Other
        kernels raise a ``ValueError`` at construction (they remain
        available on the dense ``GpRegressor`` path). The df64 solver
        tier is ``SquaredExponential``-only.
    :param mean_value: constant mean (defaults to the data mean).
    :param block_size: rows per kernel-block matmul.
    :param cg_tol: conjugate-gradient relative tolerance.
    :param cg_maxiter: conjugate-gradient iteration cap.
    :param preconditioner_rank: rank ``m`` of the low-rank preconditioner
        (0 disables it). The kernel matrix of a smooth GP is severely
        ill-conditioned at large N (lambda_max ~ N vs lambda_min ~ noise
        variance), where unpreconditioned CG stalls — especially in
        float32. The preconditioner approximates ``K ~ U U^T`` and applies
        ``(sigma^2 I + U U^T)^{-1}`` by the Woodbury identity: two (N, m)
        matmuls per CG iteration, negligible next to the O(N^2) matvec.
    :param preconditioner: "pivchol" (default) builds ``U`` by on-device
        pivoted Cholesky — m greedy pivots chosen by largest residual
        diagonal, capturing the top of K's spectrum adaptively; "nystrom"
        builds it from m random inducing rows.
    :param dtype: optional dtype override for the solve. Float32 CG hits an
        arithmetic wall when the noise is very small relative to the
        amplitude (alpha ~ y/sigma^2 amplifies matvec rounding);
        ``dtype="float64"`` runs the whole solve in float64.
        Requires ``jax.config.update("jax_enable_x64", True)``.

        Measured regime map (see BENCH_NOTES.md): float32 + ``refine()``
        reaches float64-level residuals whenever the float32 CG converges
        at all (sigma ≳ 1e-1 of the amplitude at any N; smaller sigma at
        N ≲ a few thousand). For very small noise at large N the float32
        inner CG itself breaks down (its recursive residual drifts from
        the true one) — use ``dtype="float64"`` or ``solver="df64"``.
    :param solver: "cg" (default, ``jax.scipy`` CG), "mixed" or "df64".
        "mixed" is restarted PCG with float64 scalar recurrences and
        periodic true-residual recomputation (``ops.solvers.mixed_pcg``) —
        the default CG's float32 recursive residual drifts at condition
        numbers ≳1e6 and can return garbage while reporting convergence.
        "df64" goes further for the very-small-noise regime (sigma ~ 1e-2
        of the amplitude at N ≳ 16k) where the float32 *matvec entries*
        themselves are the error floor: the covariance matvec is evaluated
        in float64 over row blocks (``ops.df64.sqexp_matvec_df64``) and
        the CG iterate/residual are float64 (``ops.solvers.df64_pcg``).
        Both require ``jax_enable_x64``; neither builds an N x N float64
        temporary.
    :param store_entries: df64 tier only. ``True``/"auto" (default)
        materialise the kernel entries once so solve iterations skip the
        dominant d^2 + exp evaluation, picking the best
        storage that fits (``ops.df64.stored_entries_tier``): the full
        float32 PAIR up to n_padded = 20480 (8 bytes/entry, ~3.4 GB),
        then the float64 entries rounded to ONE
        float32 word up to n_padded = 53248 (4 bytes/entry, ~11.3 GB),
        where CG iterates on the stored array (operator error = the
        2^-24 entry quantisation, NOT the ~1.2e-5 float32-evaluation
        noise) and the solver refreshes true residuals through the
        evaluate-per-matvec path — mixed-precision iterative refinement
        with a df64 floor. ``False`` re-evaluates entries each matvec (no N x N
        storage, any N).
    :param mesh: optional 1D mesh; data rows and solves shard over its
        first axis. With ``solver="df64"`` the float64 matvec runs
        row-sharded on every device
        (``ops.df64.sqexp_matmat_df64_sharded``) — each device evaluates
        its block of kernel rows against the replicated data, so the
        per-iteration entry evaluation scales with the device count (the
        stored-entries fast path is single-device and is skipped on a
        mesh).
    """

    def __init__(
        self,
        x,
        y,
        y_err,
        hyperpars,
        kernel=SquaredExponential,
        mean_value: float = None,
        block_size: int = 4096,
        cg_tol: float = 1e-6,
        cg_maxiter: int = 1000,
        preconditioner_rank: int = 512,
        preconditioner: str = "pivchol",
        solver: str = "cg",
        store_entries="auto",
        dtype=None,
        mesh=None,
    ):
        if solver not in ("cg", "mixed", "df64"):
            raise ValueError(
                f"[ LargeScaleGP error ] 'solver' must be 'cg', 'mixed' or "
                f"'df64', but '{solver}' was given."
            )
        self._bk = as_block_kernel(kernel, "LargeScaleGP")
        if solver == "df64" and not self._bk.supports_df64:
            raise ValueError(
                f"[ LargeScaleGP error ] solver='df64' is implemented for "
                f"the pure SquaredExponential kernel only (its pair-"
                f"tier's entry evaluation is kernel-specific); "
                f"got {self._bk.name}. Use solver='cg' or 'mixed' for "
                f"this kernel."
            )
        if solver in ("mixed", "df64") and not jax.config.read(
            "jax_enable_x64"
        ):
            raise ValueError(
                f"[ LargeScaleGP error ] solver='{solver}' requires "
                "jax.config.update('jax_enable_x64', True)."
            )
        if solver == "df64" and mesh is not None and store_entries in (True, "f32"):
            raise ValueError(
                "[ LargeScaleGP error ] store_entries=True is single-device "
                "(the stored entries live in one device's memory); with a "
                "mesh the df64 tier runs the row-sharded matvec instead "
                "— drop the flag."
            )
        self.solver = solver
        self._mesh = mesh
        if store_entries not in ("auto", True, False, "f32"):
            raise ValueError(
                f"[ LargeScaleGP error ] 'store_entries' must be 'auto', "
                f"True, False or 'f32', but {store_entries!r} was given."
            )
        if store_entries in (True, "f32") and solver != "df64":
            raise ValueError(
                "[ LargeScaleGP error ] store_entries is a df64-tier "
                "option (the stored entries serve the double-float "
                "matvec); use solver='df64' or drop the flag."
            )
        self.store_entries = store_entries
        if dtype is None:
            # df64 carries its precision in the float64 matvec and CG
            # vectors; the stored arrays (preconditioner, prediction
            # paths) stay float32
            dtype = jnp.float32 if solver == "df64" else default_float()
        else:
            dtype = jnp.dtype(dtype)
            if dtype == jnp.float64 and not jax.config.read("jax_enable_x64"):
                raise ValueError(
                    "[ LargeScaleGP error ] dtype='float64' requires "
                    "jax.config.update('jax_enable_x64', True) before any "
                    "arrays are created."
                )
        x = np.atleast_2d(np.asarray(x, dtype=float))
        if x.shape[0] == 1 and x.shape[1] > 1 and np.asarray(y).size > 1:
            x = x.T
        y = np.asarray(y, dtype=float).squeeze()
        y_err = np.asarray(y_err, dtype=float).squeeze()
        self.n_points, self.n_dimensions = x.shape
        hyperpars = np.asarray(hyperpars, dtype=float)
        expected = self._bk.n_params(self.n_dimensions)
        if hyperpars.size != expected:
            raise ValueError(
                f"[ LargeScaleGP error ] kernel {self._bk.name} over "
                f"{self.n_dimensions}-dimensional data takes {expected} "
                f"hyperparameters, but {hyperpars.size} were given."
            )
        self.hyperpars = hyperpars

        self.block_size = int(block_size)
        # pad rows to a block multiple; padded rows carry huge noise and a
        # zero residual so they leave the solve unchanged
        n_pad = -(-self.n_points // self.block_size) * self.block_size
        extra = n_pad - self.n_points
        if extra > 0:
            x = np.concatenate(
                [x, np.repeat(x.mean(axis=0, keepdims=True), extra, axis=0)]
            )
            y = np.concatenate([y, np.zeros(extra)])
            y_err = np.concatenate([y_err, np.full(extra, 1e8)])
        self._n_padded = n_pad
        self._mask = np.zeros(n_pad)
        self._mask[: self.n_points] = 1.0

        if solver == "df64":
            # fail fast on tile misalignment — BEFORE the O(N m^2) host
            # preconditioner build, which takes minutes at large N
            from ..ops.df64 import _PAD

            if n_pad % _PAD != 0:
                raise ValueError(
                    f"[ LargeScaleGP error ] solver='df64' needs the "
                    f"padded row count to be a multiple of {_PAD}; use a "
                    f"block_size that is a multiple of {_PAD}."
                )
            if mesh is not None:
                n_dev = mesh.shape[mesh.axis_names[0]]
                if n_pad % (n_dev * _PAD) != 0:
                    raise ValueError(
                        f"[ LargeScaleGP error ] solver='df64' on a "
                        f"{n_dev}-device mesh needs the padded row count "
                        f"({n_pad}) to split into per-device blocks that "
                        f"are multiples of {_PAD}; adjust block_size."
                    )

        self.mean_value = (
            float(np.mean(y[: self.n_points])) if mean_value is None else mean_value
        )

        # host copies (float64) kept for the mixed-precision refinement path
        self._x_host = x
        self._y_host = y
        self._sig_host = y_err**2

        self._x = jnp.asarray(x, dtype)
        self._y = jnp.asarray(y, dtype)
        self._sig_diag = jnp.asarray(y_err**2, dtype)
        self._mask_dev = jnp.asarray(self._mask, dtype)
        self._theta = jnp.asarray(hyperpars, dtype)

        if mesh is not None:
            axis = mesh.axis_names[0]
            shard_rows = NamedSharding(mesh, P(axis, None))
            shard_vec = NamedSharding(mesh, P(axis))
            self._x = jax.device_put(self._x, shard_rows)
            self._y = jax.device_put(self._y, shard_vec)
            self._sig_diag = jax.device_put(self._sig_diag, shard_vec)
            self._mask_dev = jax.device_put(self._mask_dev, shard_vec)

        if preconditioner not in ("pivchol", "nystrom"):
            raise ValueError(
                f"[ LargeScaleGP error ] 'preconditioner' must be 'pivchol' "
                f"or 'nystrom', but '{preconditioner}' was given."
            )
        if solver == "df64" and preconditioner == "nystrom":
            raise ValueError(
                "[ LargeScaleGP error ] solver='df64' requires the "
                "'pivchol' preconditioner: its factor is built AND applied "
                "in float64 (the f32-built, f32-applied Nystrom factor "
                "stalls the small-noise solve this solver exists for)."
            )
        self.preconditioner = preconditioner
        self._build_preconditioner(preconditioner_rank)
        self._build_compiled(cg_tol, cg_maxiter)
        self.alpha = self._solve_alpha()
        if solver == "df64":
            # the df64 solve returns a float64 iterate; keep it in full
            # precision (as refine() does) and a float32 cast for the
            # prediction paths
            self.alpha64 = np.asarray(self.alpha, np.float64)
            self.alpha = jnp.asarray(self.alpha64, dtype)
        self.cg_iterations_estimate = None  # jax cg does not report count

    def _pivoted_cholesky(self, rank: int, theta=None):
        """Partial pivoted Cholesky of the kernel matrix, entirely on
        device: ``rank`` greedy steps, each picking the point with the
        largest residual diagonal, evaluating one kernel column against all
        data, and subtracting the projection onto the factors found so far.
        Returns U with K ~ U U^T. O(N m^2) flops, never forms K. This is
        the adaptive low-rank approximation (optimal pivots track the
        kernel spectrum), where Nystrom uses blind random rows.

        ``amp``/``ls`` default to the instance hyperparameters; passing
        them explicitly (as runtime operands of a build program cached per
        rank) serves ``fit()``'s periodic live-theta preconditioner
        refresh without retracing."""
        x, mask = self._x, self._mask_dev
        n, D = x.shape
        dtype = x.dtype

        cache = getattr(self, "_pivchol_cache", None)
        if cache is None:
            cache = self._pivchol_cache = {}
        if rank in cache:
            build = cache[rank]
            return build(self._theta if theta is None else theta)

        @jax.jit
        def build(theta):
            # padded rows have zero diagonal: never pivoted. The factor
            # approximates the SMOOTH kernel part only — white noise
            # lives in the Woodbury diagonal D, not in U U^T
            diag = self._bk.amp2(theta) * mask
            U = jnp.zeros((n, rank), dtype)
            tiny = jnp.asarray(jnp.finfo(dtype).tiny, dtype)

            def body(i, carry):
                diag, U = carry
                j = jnp.argmax(diag)
                xj = lax.dynamic_slice(x, (j, 0), (1, D))
                col = self._bk.rows(x, xj, theta)[:, 0] * mask * mask[j]
                uj = lax.dynamic_slice(U, (j, 0), (1, rank))[0]
                # columns of U beyond i are still zero, so the full-width
                # matvec projects onto exactly the first i factors
                proj = jnp.dot(U, uj, precision=_HI)
                root = jnp.sqrt(jnp.maximum(diag[j], tiny))
                u = (col - proj) / root
                U = lax.dynamic_update_slice(U, u[:, None], (0, i))
                diag = jnp.maximum(diag - u * u, 0.0) * mask
                return diag, U

            _, U = lax.fori_loop(0, rank, body, (diag, U))
            return U

        cache[rank] = build
        return build(self._theta if theta is None else theta)

    def _pivoted_cholesky_host(self, rank: int) -> np.ndarray:
        """Greedy pivoted Cholesky in HOST float64. The on-device float32
        build accumulates ~eps32*amp^2*m residual-diagonal error over m
        steps — at sigma = 0.01 that rivals sigma^2 itself and the
        resulting preconditioner stalls the df64 solve (measured at
        N=50k, rank 1024: relative residual stuck at 0.88). O(N m^2)
        numpy flops, built once."""
        h = np.asarray(self.hyperpars, np.float64)
        amp2 = np.exp(2.0 * h[0])
        ls = np.exp(h[1:])
        xs = np.asarray(self._x_host, np.float64) / ls[None, :]
        n = xs.shape[0]
        diag = amp2 * self._mask.astype(np.float64)
        U = np.zeros((n, rank))
        for i in range(rank):
            j = int(np.argmax(diag))
            d2 = ((xs - xs[j]) ** 2).sum(axis=1)
            col = amp2 * np.exp(-0.5 * d2) * self._mask * self._mask[j]
            proj = U[:, :i] @ U[j, :i]
            root = np.sqrt(max(diag[j], np.finfo(np.float64).tiny))
            u = (col - proj) / root
            U[:, i] = u
            diag = np.maximum(diag - u * u, 0.0) * self._mask
        return U

    def _build_preconditioner(self, rank: int):
        """Low-rank preconditioner: K ~ U U^T (pivoted Cholesky or
        Nystrom), with (sigma^2 I + U U^T)^{-1} applied by the Woodbury
        identity."""
        if rank <= 0 or rank >= self.n_points:
            self._precond = None
            self._precond64 = None
            return
        dtype = self._x.dtype
        self._precond64 = None

        if self.preconditioner == "pivchol":
            if self.solver == "df64":
                # float64 host BUILD and float64 APPLICATION operands —
                # both matter at small noise. Build: the f32 device build
                # accumulates ~eps32*amp^2*m residual-diagonal error,
                # rivalling sigma^2 itself. Application: the Woodbury core
                # has kappa ~ amp^2 N / sigma^2 (~1e8-1e9 at sigma=0.01)
                # and its subtraction cancels ~8 digits, so an f32-applied
                # preconditioner stalls PCG at 1e-4..1e-6 even with an
                # EXACT f64 matvec (measured; f64 application converges to
                # 1e-12 in <50 iterations on the same system).
                U64 = self._pivoted_cholesky_host(rank)
                amp2 = np.exp(2.0 * self.hyperpars[0])
                d64 = self._sig_host + amp2 * 1e-12
                V64 = U64 / d64[:, None]
                G = V64.T @ U64
                # explicit core inverse: the f64 M application is then
                # pure (N, m) matmuls; as a preconditioner the explicit
                # inverse's kappa*eps64 ~ 1e-7 relative error is
                # irrelevant
                Cinv = self._core_inverse_host(G)
                self._precond64 = (
                    jnp.asarray(U64, jnp.float64),
                    jnp.asarray(Cinv, jnp.float64),
                    jnp.asarray(1.0 / d64, jnp.float64),
                )
                # float32 casts serve the traced prediction paths, which
                # only need O(amp^2)-scale accuracy
                self._precond = (
                    jnp.asarray(U64, dtype),
                    jnp.asarray(d64, dtype),
                    self._factor_woodbury_core(jnp.asarray(G)),
                )
                return
            U = self._pivoted_cholesky(rank)
            d, G = self._precond_gram(U, self._theta)
            self._precond = (U, d, self._factor_woodbury_core(G))
            return

        idx = np.random.default_rng(0).choice(self.n_points, rank, replace=False)
        xm = self._x[jnp.asarray(np.sort(idx))]

        @jax.jit
        def build():
            theta = self._theta
            amp2 = self._bk.amp2(theta)
            K_mm = self._bk.rows(xm, xm, theta)
            n = K_mm.shape[0]
            # generous jitter: inducing rows of a smooth kernel are highly
            # correlated and K_mm is near-singular in float32; the
            # preconditioner only needs K ~ U U^T approximately, so a large
            # diagonal shift costs a few extra CG iterations, not accuracy
            jit_scale = 1e-3 if K_mm.dtype == jnp.float32 else 1e-8
            K_mm = K_mm.at[jnp.arange(n), jnp.arange(n)].add(
                amp2 * jit_scale
            )
            L_mm = jnp.linalg.cholesky(K_mm)
            K_nm = self._bk.rows(self._x, xm, theta)
            # U = K_nm L^-T  =>  U U^T = K_nm K_mm^-1 K_mn (Nystrom)
            U = jax.scipy.linalg.solve_triangular(
                L_mm, K_nm.T, lower=True
            ).T
            # mask padded rows out of the preconditioner
            U = U * self._mask_dev[:, None]
            # Woodbury-core Gram: G = U^T D^-1 U, D = sig + noise + jitter
            d = (
                self._sig_diag
                + self._bk.noise_variance(theta)
                + amp2 * 1e-12
            )
            G = jnp.dot((U / d[:, None]).T, U, precision=_HI)
            return U, d, G

        # stored as arrays and passed to the jitted solve as runtime
        # arguments — capturing the (N, m) factor in a closure would embed
        # it in the compiled program as a constant (hundreds of MB at large
        # N)
        U, d, G = build()
        self._precond = (U, d, self._factor_woodbury_core(G))

    def _precond_gram(self, U, theta):
        """Jitter-shifted diagonal and Woodbury-core Gram ``G = U^T D^-1 U``
        for a low-rank factor, shared by the construction-time build and
        ``fit()``'s live-theta refresh (one program, cached)."""
        fn = getattr(self, "_precond_gram_fn", None)
        if fn is None:

            @jax.jit
            def fn(U, theta):
                d = (
                    self._sig_diag
                    + self._bk.noise_variance(theta)
                    + self._bk.amp2(theta) * 1e-12
                )
                G = jnp.dot((U / d[:, None]).T, U, precision=_HI)
                return d, G

            self._precond_gram_fn = fn
        return fn(U, theta)

    @staticmethod
    def _factor_core_host(G) -> np.ndarray:
        """Float64 host Cholesky of the Woodbury core C = I + G, with an
        escalating-jitter retry. With small noise the Gram entries reach
        ~amp^2 N / sigma^2 (1e8+ in the sigma = 1e-2 regime) and a float32
        device Cholesky goes indefinite -> NaN, silently poisoning the
        preconditioner so CG exits at its starting point. The m x m core is
        tiny: one small transfer and a float64 factorisation make the
        preconditioner robust at any noise level. Shared by the f32
        (``_factor_woodbury_core``) and df64 (``_core_inverse_host``)
        preconditioner builds — the jitter policy must stay identical."""
        m = G.shape[0]
        C = np.eye(m) + 0.5 * (
            np.asarray(G, np.float64) + np.asarray(G, np.float64).T
        )
        bump = 0.0
        scale = float(np.diag(C).max())
        for _ in range(6):
            try:
                return np.linalg.cholesky(C + bump * np.eye(m))
            except np.linalg.LinAlgError:
                bump = max(bump * 100.0, 1e-10 * scale)
        raise np.linalg.LinAlgError(
            "[ LargeScaleGP error ] preconditioner core factorisation "
            "failed even with diagonal regularisation"
        )

    @classmethod
    def _core_inverse_host(cls, G) -> np.ndarray:
        """Explicit float64 inverse of the Woodbury core C = I + G on the
        host, for the df64 solver's all-matmul f64 application."""
        L = cls._factor_core_host(G)
        Linv = np.linalg.inv(L)
        return Linv.T @ Linv

    def _factor_woodbury_core(self, G) -> jnp.ndarray:
        """Host-f64 Cholesky of C = I + G, cast to the solve dtype for the
        traced f32 preconditioner application (see ``_factor_core_host``)."""
        return jnp.asarray(self._factor_core_host(G), self._x.dtype)

    def _df64_op_args(self):
        """Runtime operands of the double-float system operator: the
        stored entry pair when materialised, else the scaled-coordinate
        pair. Passed as arguments on every solver dispatch — a bound
        method closing over an (n, n) device array would embed it in the
        compiled chunk's HLO module as a constant (the stored pair is
        ~2 GB at n=16384)."""
        if self._entries is not None:
            return self._entries
        return (self._us_hi, self._us_lo)

    def _matvec64_pair(self, v32, op_a, op_b):
        """Double-float system matvec: float32 vector in, float64
        ``(K + diag(sig) + jitter I) v`` out — the float64 covariance
        matvec (or the stored-entries contraction when the entry pair is
        materialised) plus the float64 diagonal (``ops/df64.py``).
        ``(op_a, op_b)`` is ``_df64_op_args()``, threaded through as
        runtime operands."""
        Ev = self._entries_apply(v32.reshape(-1, 1), op_a, op_b)[:, 0]
        amp2 = np.exp(2.0 * float(self.hyperpars[0]))
        diag = self._sig64 + amp2 * 1e-12
        return amp2 * Ev + diag * v32.astype(jnp.float64)

    def _matmat64_pair(self, V32, op_a, op_b):
        """Multi-RHS double-float system matmat: float32 (n, q) block in,
        float64 ``(K + diag(sig) + jitter I) V`` out — the column-batched
        matmat amortises the entry evaluation across right-hand sides
        (``ops/df64.py::sqexp_matmat_df64``)."""
        EV = self._entries_apply(V32, op_a, op_b)
        amp2 = np.exp(2.0 * float(self.hyperpars[0]))
        diag = self._sig64 + amp2 * 1e-12
        return amp2 * EV + diag[:, None] * V32.astype(jnp.float64)

    def _matvec64_fast_f32(self, v32, E):
        """Fast-iteration system matvec for the stored-f32 tier: exact
        contraction over the stored entries (error = their 2^-24
        quantisation), float64 out. Used for Df64Solver ITERATIONS only;
        refreshes anchor on ``_matvec64_pair``. ``E`` travels as a
        runtime operand (compile-payload trap — it is ~10 GB at n=51k)."""
        return self._matmat64_fast_f32(v32.reshape(-1, 1), E)[:, 0]

    def _matmat64_fast_f32(self, V32, E):
        from ..ops.df64 import sqexp_stored_f32_matmat

        EV = sqexp_stored_f32_matmat(E, V32)
        amp2 = np.exp(2.0 * float(self.hyperpars[0]))
        diag = self._sig64 + amp2 * 1e-12
        return amp2 * EV + diag[:, None] * V32.astype(jnp.float64)

    def _entries_apply(self, V32, op_a, op_b):
        """``E V`` through the stored entry pair when materialised, the
        row-sharded matvec on a mesh, else the single-device
        evaluate-per-matvec path. The branch is resolved at trace time
        (``self._entries``/``self._mesh`` are static); ``(op_a, op_b)``
        carries the branch's arrays as runtime operands."""
        if self._entries is not None:
            from ..ops.df64 import sqexp_stored_matmat_df64

            return sqexp_stored_matmat_df64(op_a, op_b, V32)
        if self._mesh is not None:
            from ..ops.df64 import sqexp_matmat_df64_sharded

            return sqexp_matmat_df64_sharded(op_a, op_b, V32, self._mesh)
        from ..ops.df64 import sqexp_matmat_df64

        return sqexp_matmat_df64(op_a, op_b, V32)

    def _prepare_df64(self):
        """Pre-split the scaled coordinates into a float32 pair (computed
        in host float64 — hyperparameters are fixed for the solve). When
        the stored-entries policy applies, materialise the pair entries
        ``(E_hi, E_lo)`` once (8 bytes/entry of device memory): every
        later solve iteration then skips the d^2 + exp evaluation."""
        from ..ops.df64 import split_f64, _PAD

        if self._n_padded % _PAD != 0:
            raise ValueError(
                f"[ LargeScaleGP error ] solver='df64' needs the padded "
                f"row count to be a multiple of {_PAD}; use a block_size "
                f"that is a multiple of {_PAD}."
            )
        ls64 = np.exp(np.asarray(self.hyperpars[1:], np.float64))
        uh, ul = split_f64(self._x_host / ls64[None, :])
        self._us_hi = jnp.asarray(uh)
        self._us_lo = jnp.asarray(ul)
        self._sig64 = jnp.asarray(self._sig_host, jnp.float64)
        self._entries = None
        self._entries_f32 = None
        if self._mesh is not None:
            # the mesh path runs the row-sharded matvec; a stored (n, n)
            # entry pair lives in one device's memory
            return
        from ..ops.df64 import stored_entries_tier

        tier = stored_entries_tier(self._n_padded, self.store_entries)
        if tier == "f32" and self.store_entries == "auto":
            # soundness guard for the default policy: the stored-f32
            # entries carry 2^-24 relative quantisation whose spectral
            # norm is ROW-SUM scale (correlated rounding of smoothly-
            # varying entries), i.e. ||dK|| ~ amp^2 * 2^-24 * max row
            # sum of E. Iterative refinement over the quantised
            # operator contracts only while that stays within a modest
            # multiple of the sigma^2 diagonal (measured: ratio ~2
            # converges to the df64 floor at N=50k; a data-space system
            # at ratio ~200 stalls 4 decades short) — past the margin,
            # 'auto' falls back to the evaluate-per-matvec path. Explicit
            # store_entries='f32' overrides.
            rng = np.random.default_rng(0)
            us = self._x_host[: self.n_points] / ls64[None, :]
            rows = rng.choice(
                self.n_points, size=min(self.n_points, 512), replace=False
            )
            a = us[rows]
            # |a-b|^2 via the matmul identity — an ESTIMATE of the row-sum
            # scale, so host-f64 cancellation (~1e-10) is irrelevant here
            d2 = np.maximum(
                (a**2).sum(1)[:, None]
                + (us**2).sum(1)[None, :]
                - 2.0 * (a @ us.T),
                0.0,
            )
            max_rowsum = float(np.exp(-0.5 * d2).sum(axis=1).max())
            amp2 = float(np.exp(2.0 * self.hyperpars[0]))
            quant_norm = amp2 * 2.0**-24 * max_rowsum
            sig2_min = float(self._sig_host[: self.n_points].min())
            if quant_norm > 32.0 * sig2_min:
                warn(
                    f"[ LargeScaleGP warning ] store_entries='auto' is "
                    f"falling back to the evaluate-per-matvec df64 path: the stored-"
                    f"f32 entry quantisation (spectral scale ~"
                    f"{quant_norm:.1e}) exceeds 32x the smallest noise "
                    f"variance ({sig2_min:.1e}), where the quantised "
                    f"operator's iterative refinement is measured to "
                    f"stall above the requested tolerance. Solves will "
                    f"be slower but accurate; pass store_entries='f32' "
                    f"to force the stored tier anyway."
                )
                tier = None
        if tier == "pair":
            from ..ops.df64 import sqexp_entries_df64

            self._entries = sqexp_entries_df64(self._us_hi, self._us_lo)
        elif tier == "f32":
            # float64 entries rounded to one float32 word
            # (4 bytes/entry): iteration matvecs run on the stored
            # array while the solver's true-residual refreshes go
            # through the evaluate-per-matvec path (iterative refinement —
            # see ops/solvers.py::Df64MultiSolver)
            from ..ops.df64 import sqexp_entries_f32

            self._entries_f32 = sqexp_entries_f32(self._us_hi, self._us_lo)

    def _df64_chunk(self) -> int:
        """CG iterations per compiled Df64Solver chunk (the true-residual
        refresh period).

        Fused / stored-pair tiers: the solver's default period.

        Stored-f32 tier: a SHORT chunk. The iteration operator carries
        the 2^-24 entry quantisation, whose spectral norm ||dK|| is
        row-sum scale (the rounding of smoothly-varying entries is
        correlated, not random-sign): at n ~ 50k, ||dK|| ~ 2^-24 *
        (row sums ~ 3e3) ~ 2e-4 EXCEEDS the sigma^2 = 1e-4 diagonal, so
        the stored operator is slightly INDEFINITE — inner CG that digs
        below that level breaks down (measured at N=50,000: a
        50-iteration chunk trips the pAp latch and freezes at 1.7e-4,
        while refresh-per-iteration converges to 7e-10 and stagnates
        stably). Each true-residual refresh contracts >= 100x
        (measured), so ~4-6 refreshes reach the df64 floor; 4 inner
        iterations per refresh keeps the inner solve comfortably above
        the quantisation depth while the refresh (1 accurate + 1 fast
        matvec) amortises over them."""
        return 4 if self._entries_f32 is not None else DF64_RESTART_EVERY

    def _df64_fast_kwargs(self, kind: str):
        """Constructor kwargs wiring the stored-f32 fast-iteration matvec
        into a Df64Solver ('matvec') or Df64MultiSolver ('matmat');
        empty when the tier is not active."""
        if self._entries_f32 is None:
            return {}
        if kind == "matvec":
            return {
                "matvec_fast": self._matvec64_fast_f32,
                "matvec_fast_args": (self._entries_f32,),
            }
        return {
            "matmat_fast": self._matmat64_fast_f32,
            "matmat_fast_args": (self._entries_f32,),
        }

    def _system_matmat(self, theta, V):
        """(K(theta) + diag(sig) + noise + jitter I) applied to a vector
        (n_pad,) or a column block (n_pad, q), in kernel row blocks — one
        blocked matmul serves every column at once (``jnp.dot`` handles
        1-D and 2-D right operands uniformly). This is the single
        solve-critical system decomposition: the fixed-theta solve paths
        and ``fit()``'s live-theta autodiff both call it, so jitter
        policy / precision / padding handling cannot drift between
        them."""
        x = self._x
        n_pad, block = self._n_padded, self.block_size
        x_blocks = x.reshape(n_pad // block, block, -1)

        def one_block(xb):
            return jnp.dot(self._bk.rows(xb, x, theta), V, precision=_HI)

        KV = lax.map(one_block, x_blocks).reshape((n_pad,) + V.shape[1:])
        diag = (
            self._sig_diag
            + self._bk.noise_variance(theta)
            + self._bk.amp2(theta) * 1e-12
        )
        return KV + (diag * V.T).T

    def _build_compiled(self, cg_tol, cg_maxiter):
        x, theta = self._x, self._theta
        has_precond = self._precond is not None

        def matvec(v):
            return self._system_matmat(theta, v)

        use_mixed = self.solver == "mixed"
        use_df64 = self.solver == "df64"
        if use_df64:
            self._prepare_df64()

        def make_preconditioner(pc):
            if not has_precond:
                return None
            U, d, L_c = pc
            return lambda v: woodbury_apply(
                v, U, 1.0 / d, L_c, core_chol=True
            )

        def solve(rhs, pc):
            """Traced float32 solve — for the df64 solver this is the
            fallback used only inside compiled prediction programs
            (posterior variances are O(amp^2) quantities that do not need
            df64 accuracy); training solves go through the host-driven
            chunked Df64Solver instead."""
            M = make_preconditioner(pc)
            if use_mixed or use_df64:
                from ..ops.solvers import mixed_pcg

                sol, _ = mixed_pcg(
                    matvec, rhs, M=M, tol=cg_tol, maxiter=cg_maxiter
                )
            else:
                sol, _ = cg(matvec, rhs, tol=cg_tol, maxiter=cg_maxiter, M=M)
            return sol

        def solve_alpha(pc):
            rhs = (self._y - self.mean_value) * self._mask_dev
            return solve(rhs, pc)

        solve_alpha_jit = jax.jit(solve_alpha)
        self._matvec = jax.jit(matvec)
        solve_jit = jax.jit(solve)
        if use_df64:
            from ..ops.solvers import Df64Solver

            if has_precond:
                def M_df64(v64, U64, Cinv, dinv):
                    # ENTIRELY in f64 — see woodbury_apply on why
                    return woodbury_apply(
                        v64, U64, dinv, Cinv, core_chol=False
                    )

                # the (N, m) factor travels as a runtime operand, never a
                # baked-in program constant
                self._df64_solver = Df64Solver(
                    self._matvec64_pair, M=M_df64, M_args=self._precond64,
                    matvec_args=self._df64_op_args(),
                    restart_every=self._df64_chunk(),
                    **self._df64_fast_kwargs("matvec"),
                )
            else:
                self._df64_solver = Df64Solver(
                    self._matvec64_pair,
                    matvec_args=self._df64_op_args(),
                    restart_every=self._df64_chunk(),
                    **self._df64_fast_kwargs("matvec"),
                )
            def solve_rhs_checked(rhs):
                sol, info = self._df64_solver.solve(
                    jnp.asarray(rhs).astype(jnp.float64),
                    tol=cg_tol,
                    maxiter=cg_maxiter,
                )
                if info != 0:
                    hint = (
                        " The stored-f32 entry tier is active: its "
                        "2^-24 quantisation may exceed the noise scale "
                        "— retry with store_entries=False."
                        if self._entries_f32 is not None
                        else " Raise cg_maxiter or loosen cg_tol."
                    )
                    warn(
                        f"[ LargeScaleGP warning ] the df64 training "
                        f"solve stopped after {info} iterations above "
                        f"the requested tolerance {cg_tol:.1e}; the "
                        f"best iterate is returned but may be "
                        f"inaccurate.{hint}"
                    )
                return sol

            self._solve_rhs = solve_rhs_checked
            # rhs from the float64 HOST data: building it from the float32
            # device copy would floor the solve at eps32 and defeat the
            # solver's whole purpose
            self._solve_alpha = lambda: self._solve_rhs(
                jnp.asarray((self._y_host - self.mean_value) * self._mask)
            )
        else:
            self._solve_alpha = lambda: solve_alpha_jit(self._precond)
            self._solve_rhs = lambda rhs: solve_jit(rhs, self._precond)

        def predict_mean(q, alpha):
            K_qx = self._bk.rows(q, x, theta)
            return jnp.dot(K_qx, alpha, precision=_HI) + self.mean_value

        self._predict_mean = jax.jit(predict_mean)

        # the batched variance solves apply the same operator to an
        # (n_pad, q) block — matvec handles both shapes
        matvec_multi = matvec

        def predict_var(q, alpha, pc):
            from ..ops.solvers import pcg_multi

            K_qx = self._bk.rows(q, x, theta)  # (M, n_pad)
            if has_precond:
                U, d, L_c = pc
                M_multi = lambda V: woodbury_apply(
                    V, U, 1.0 / d, L_c, core_chol=True
                )
            else:
                M_multi = None
            sols, _ = pcg_multi(
                matvec_multi, K_qx.T, M=M_multi, tol=cg_tol, maxiter=cg_maxiter
            )
            quad = jnp.sum(K_qx.T * sols, axis=0)
            return self._bk.amp2(theta) - quad

        predict_var_jit = jax.jit(predict_var)
        self._cg_tol, self._cg_maxiter = cg_tol, cg_maxiter
        if self.solver == "df64":
            # the batched f32 CG above cannot serve the regime this tier
            # exists for: at sigma ~ 1e-2 both the f32 matvec entries and
            # the amp^2 - quad cancellation floor the variances FAR above
            # their sigma^2-scale truth (measured: absolute errors 1e-3+
            # against truth ~1e-5) — route each query column through the
            # chunked df64 solve instead
            self._predict_var = self._predict_var_df64
        else:
            self._predict_var = lambda q, alpha: predict_var_jit(
                jnp.asarray(q, self._x.dtype), alpha, self._precond
            )

    def fit(
        self,
        n_steps: int = 40,
        learning_rate: float = 0.05,
        n_probes: int = 8,
        fit_tol: float = 1e-3,
        fit_maxiter: int = 150,
        precond_every: int = 10,
        seed: int = 0,
        verbose: bool = False,
    ):
        """
        Select hyperparameters by maximising the log-marginal likelihood
        **without ever forming K** — the capability the dense
        ``GpRegressor.fit`` cannot offer past ~10^4 points (the reference
        library has no large-N fitting at all: its ``GpRegressor``
        factorises dense K per objective evaluation,
        reference: inference/gp/regression.py:528-567).

        Matrix-free stochastic gradients: per Adam step, ONE batched
        multi-right-hand-side CG solve (``ops.solvers.pcg_multi``) computes
        ``alpha = K^-1 r`` and ``u_i = K^-1 z_i`` for Rademacher probes
        ``z_i`` together — every CG iteration is one blocked kernel matmul
        shared by all systems. The LML gradient follows from

            dL/dtheta = 0.5 alpha^T (dK) alpha - 0.5 tr(K^-1 dK),
            tr(K^-1 dK) ~ mean_i  u_i^T (dK) z_i      (Hutchinson),

        assembled by autodiff of the **blocked matvec** ``K(theta) w``
        with ``alpha, u`` held fixed — no dK matrix, no dense pass. The
        probes are drawn once and reused across steps (common random
        numbers), so the stochastic objective is a fixed smooth function
        and Adam converges on it cleanly.

        Returns the optimised kernel hyperparameter vector (does not
        mutate this instance — construct a new ``LargeScaleGP`` with the
        returned vector, matching ``GpRegressor.fit``'s contract).

        ``fit_tol``/``fit_maxiter`` bound the inner CG: stochastic
        gradients tolerate loose solves (1e-3 is ample), and each Adam
        step is a single bounded device dispatch. A step whose CG stops above
        ``max(10 * fit_tol, 0.05)`` relative residual triggers a warning
        — the gradient is substantially biased there, so raise
        ``fit_maxiter`` or start the fit from a better-conditioned
        initialisation.

        The inner CG runs under the instance's low-rank preconditioner,
        REBUILT at the live hyperparameters every ``precond_every`` steps
        (on-device pivoted Cholesky + one m x m host-f64 core
        factorisation). A stale preconditioner stays symmetric positive
        definite, so intermediate steps remain exact-CG-correct — only
        the convergence rate decays as theta wanders, which the periodic
        refresh bounds. Set ``precond_every=0`` to pin the
        construction-time preconditioner for the whole fit.
        """
        if n_probes < 1:
            raise ValueError(
                "LargeScaleGP.fit requires n_probes >= 1 — the Hutchinson "
                "trace term has no estimate from zero probes"
            )
        n_pad = self._n_padded
        wd = self._x.dtype

        rng = np.random.default_rng(seed)
        probes = jnp.asarray(
            rng.choice([-1.0, 1.0], size=(n_pad, n_probes))
            * self._mask[:, None],
            wd,
        )
        rhs0 = jnp.asarray(
            (self._y_host - self.mean_value) * self._mask, wd
        )

        use_precond = self._precond is not None
        fit_step = self._get_fit_step(
            float(fit_tol), int(fit_maxiter), use_precond
        )

        theta = jnp.asarray(self.hyperpars, wd)
        adam = (jnp.zeros_like(theta), jnp.zeros_like(theta))
        pc = self._fit_precond_initial() if use_precond else None
        warned = False
        for step in range(int(n_steps)):
            if use_precond and precond_every and step and step % precond_every == 0:
                pc = self._fit_precond(theta)
            pc_args = (pc,) if use_precond else ()
            theta, adam, g, data_fit, rel_resid = fit_step(
                theta, adam, jnp.asarray(step + 1, wd),
                jnp.asarray(learning_rate, wd), rhs0, probes, *pc_args,
            )
            if not warned and float(rel_resid) > max(10.0 * fit_tol, 0.05):
                import warnings

                warnings.warn(
                    f"LargeScaleGP.fit: inner CG stopped at relative "
                    f"residual {float(rel_resid):.2e} on step {step + 1} — "
                    f"the stochastic gradient is substantially biased; "
                    f"increase fit_maxiter or reduce the step size"
                )
                warned = True
            if verbose:
                print(
                    f"  [ LargeScaleGP.fit step {step + 1}/{n_steps}: "
                    f"|grad| {float(jnp.linalg.norm(g)):.3e}, data-fit "
                    f"{float(data_fit):.4f}, CG resid "
                    f"{float(rel_resid):.1e}, theta "
                    f"{np.asarray(theta).round(3)} ]",
                    flush=True,
                )
        return np.asarray(theta, float)

    def _fit_precond(self, theta):
        """Rebuild the low-rank preconditioner triple (U, d_inv, C_inv)
        at live hyperparameters for ``fit()``: on-device pivoted Cholesky
        (program cached per rank — no retrace across refreshes) plus the
        host-f64 explicit Woodbury-core inverse (an m x m transfer; the
        f32 device Cholesky of the core goes indefinite at small noise).
        Under ``jax_enable_x64`` the inverse diagonal and core stay
        float64 so the fit step can apply the core in f64 — the core's
        condition reaches ~amp^2 N / sigma^2 (1e7+ on realistic
        problems), where an all-f32 application returns garbage and PCG
        diverges (measured: worst-column residuals 3-9 at N=16k even
        with a freshly rebuilt rank-1024 factor)."""
        th = np.asarray(theta, np.float64)
        rank = self._precond[0].shape[1]
        U = self._pivoted_cholesky(
            rank, theta=jnp.asarray(th, self._x.dtype)
        )
        return self._fit_pc_from_U(U, th)

    def _fit_pc_from_U(self, U, theta64):
        """Fit-format triple (U, d_inv, C_inv) from a low-rank factor:
        device Gram, host-f64 core inverse, x64-gated core dtype."""
        th = np.asarray(theta64, np.float64)
        _, G = self._precond_gram(U, jnp.asarray(th, self._x.dtype))
        cdtype = (
            jnp.float64
            if jax.config.read("jax_enable_x64")
            else self._x.dtype
        )
        dinv = 1.0 / (
            self._sig_host
            + self._bk.noise_variance_host(th)
            + self._bk.amp2_host(th) * 1e-12
        )
        Cinv = self._core_inverse_host(np.asarray(G))
        return U, jnp.asarray(dinv, cdtype), jnp.asarray(Cinv, cdtype)

    def _fit_precond_initial(self):
        """The fit-format preconditioner at the CONSTRUCTION
        hyperparameters, derived from factors already built — ``fit()``
        must not pay a duplicate O(N m^2) pivoted-Cholesky build for the
        theta the constructor already factored. df64 tier: ``_precond64``
        already holds the host-f64 (U, C_inv, 1/d); other tiers reuse the
        stored U and recompute only the m x m core inverse."""
        cdtype = (
            jnp.float64
            if jax.config.read("jax_enable_x64")
            else self._x.dtype
        )
        if getattr(self, "_precond64", None) is not None:
            U64, Cinv, dinv = self._precond64
            return (
                jnp.asarray(U64, self._x.dtype),
                jnp.asarray(dinv, cdtype),
                jnp.asarray(Cinv, cdtype),
            )
        return self._fit_pc_from_U(self._precond[0], self.hyperpars)

    def _get_fit_step(self, fit_tol, fit_maxiter, use_precond):
        """One jitted Adam step of the stochastic-LML fit, cached per
        (tol, maxiter) so repeated ``fit()`` calls (restarts from several
        initialisations, warm-up runs) reuse the compiled program instead
        of retracing. Probe-count changes re-specialise via jit's shape
        cache; the learning rate, step index and preconditioner factors
        are runtime operands."""
        cache = getattr(self, "_fit_step_cache", None)
        if cache is None:
            cache = self._fit_step_cache = {}
        key = (fit_tol, fit_maxiter, use_precond)
        if key in cache:
            return cache[key]

        from ..ops.solvers import pcg_multi

        @jax.jit
        def fit_step(theta, adam, t, lr, rhs, Z, *pc):
            th0 = lax.stop_gradient(theta)
            B = jnp.concatenate([rhs[:, None], Z], axis=1)
            if use_precond:
                Up, dinv, Cinv = pc[0]
                # core applied in dinv's dtype — float64 under x64; the
                # f64 cost is two (n, m) matmuls per CG
                # iteration, noise next to the (n, n) system matmat
                M_multi = lambda V: woodbury_apply(
                    V, Up, dinv, Cinv, core_chol=False, out_dtype=V.dtype
                )
            else:
                M_multi = None
            Sol, _ = pcg_multi(
                lambda V: self._system_matmat(th0, V),
                B,
                M=M_multi,
                tol=fit_tol,
                maxiter=fit_maxiter,
            )
            Sol = lax.stop_gradient(Sol)
            alpha, U = Sol[:, :1], Sol[:, 1:]
            # true relative residual, worst column — pcg_multi can stop
            # at maxiter with unconverged columns, and a silently-loose
            # solve biases the gradient (costs one extra matmat ~ one CG
            # iteration per step)
            R = B - self._system_matmat(th0, Sol)
            rel_resid = jnp.sqrt(
                jnp.max(jnp.sum(R * R, axis=0) / jnp.sum(B * B, axis=0))
            )

            def surrogate(th):
                # S(th) = -0.5 a^T K a + 0.5 mean_i u_i^T K z_i has
                # dS = -dL with alpha/U fixed: minimising S maximises LML
                KW = self._system_matmat(
                    th, jnp.concatenate([alpha, Z], axis=1)
                )
                s_data = -0.5 * jnp.sum(alpha[:, 0] * KW[:, 0])
                s_trace = 0.5 * jnp.mean(jnp.sum(U * KW[:, 1:], axis=0))
                return s_data + s_trace

            g = jax.grad(surrogate)(theta)
            m, v = adam
            b1, b2, eps = 0.9, 0.999, 1e-8
            m = b1 * m + (1.0 - b1) * g
            v = b2 * v + (1.0 - b2) * g * g
            m_hat = m / (1.0 - b1**t)
            v_hat = v / (1.0 - b2**t)
            theta = theta - lr * m_hat / (jnp.sqrt(v_hat) + eps)
            # exact data-fit term for monitoring (trace term is the
            # stochastic part); alpha solved at th0
            data_fit = -0.5 * jnp.sum(alpha[:, 0] * rhs)
            return theta, (m, v), g, data_fit, rel_resid

        cache[key] = fit_step
        return fit_step

    def __call__(self, points, with_variance: bool = False):
        """
        Predictive means (and optionally standard deviations — one CG solve
        per query point) at the given locations. With ``solver="df64"``
        the variance solves run through the chunked double-float machinery
        (one host-driven solve per query point, typically <= 15 iterations
        under the f64-applied preconditioner) — the batched float32 CG the
        other tiers use floors far above sigma^2-scale variances at small
        noise.
        """
        q_host = np.atleast_2d(np.asarray(points, dtype=float))
        if q_host.shape[1] != self.n_dimensions:
            q_host = q_host.reshape(-1, self.n_dimensions)
        if self.solver == "df64":
            # mean at float64 too: alpha is K^{-1}(y - mean) and grows as
            # 1/sigma^2 at small noise, so the f32 device dot's
            # sqrt(n) * eps32 * |alpha| rounding is ~1e-2 ABSOLUTE error
            # at sigma=0.01, N=16k (measured) — the host f64
            # contraction with alpha64 is exact to the solve's accuracy
            if with_variance:
                # one host f64 cross-covariance per query block serves
                # both the mean contraction and the variance right-hand
                # sides (building K(q, x) twice doubled the host kernel
                # work on every prediction call)
                mu, var = self._predict_var_df64(
                    q_host, self.alpha, return_mean=True
                )
                return mu, np.sqrt(np.abs(var))
            return self._predict_mean_df64(q_host)
        q = jnp.asarray(q_host, self._x.dtype)
        mu = np.asarray(self._predict_mean(q, self.alpha))
        if not with_variance:
            return mu
        # the variance path receives the FLOAT64 host query points: the
        # df64 tier would otherwise inherit f32-truncated positions and
        # with them an eps32-scale floor on the quadratic form
        var = np.asarray(self._predict_var(q_host, self.alpha))
        return mu, np.sqrt(np.abs(var))

    def _kqx_host64(self, q64):
        """Float64 host cross-covariance rows ``K(q, x)`` (query block x
        padded points, padded columns masked to zero) — see
        ``sqexp_rows_host64`` for the numerical rationale."""
        return (
            sqexp_rows_host64(q64, self._x_host, self.hyperpars)
            * self._mask[None, :]
        )

    # query-block width for the host f64 mean contraction: bounds the
    # (chunk, n_padded) cross-covariance block at ~100 MB for N=50k
    _DF64_MEAN_CHUNK = 256

    def _predict_mean_df64(self, q_host):
        """Posterior means for the df64 tier: host float64 cross-covariance
        against the float64 solve iterate ``alpha64`` (the f32 device dot
        floors at sqrt(n) * eps32 * |alpha| absolute — far above the
        solve's accuracy at small noise)."""
        q64 = np.atleast_2d(np.asarray(q_host, np.float64))
        m = q64.shape[0]
        mu = np.empty(m)
        step = self._DF64_MEAN_CHUNK
        for start in range(0, m, step):
            stop = min(start + step, m)
            Kqx = self._kqx_host64(q64[start:stop])
            mu[start:stop] = Kqx @ self.alpha64
        return mu + self.mean_value

    def _predict_var_df64(self, q_host, alpha, return_mean: bool = False):
        """Posterior-variance quadratic forms for the df64 tier, at
        float64 accuracy end to end: float64 host cross-covariance rows,
        one chunked df64 solve per query point (float64 matvec +
        f64-applied Woodbury preconditioner), and the quadratic form
        accumulated in host float64 — the amp^2 - quad subtraction
        cancels to sigma^2 scale at small noise, far below float32
        reach (reference computes this trivially in host f64:
        inference/gp/regression.py:204-216). With ``return_mean`` the
        same cross-covariance block also contracts against ``alpha64``,
        returning ``(means, variances)`` without a second K(q, x) pass."""
        import warnings

        q64 = np.atleast_2d(np.asarray(q_host, np.float64))
        amp2 = float(np.exp(2.0 * self.hyperpars[0]))

        m = q64.shape[0]
        qc = self._DF64_VAR_COLS
        solver = self._get_df64_multi_solver()
        quad = np.empty(m)
        mu = np.empty(m) if return_mean else None
        for start in range(0, m, qc):
            stop = min(start + qc, m)
            # cross-covariance built per block: the full-query (m, n, d)
            # displacement temporary is a host OOM hazard at scale
            Kqx = self._kqx_host64(q64[start:stop])
            if return_mean:
                mu[start:stop] = Kqx @ self.alpha64
            # fixed-width blocks (zero-padded columns converge instantly)
            # keep ONE compiled chunk program across all query counts
            B = np.zeros((self._n_padded, qc))
            B[:, : stop - start] = Kqx.T
            # 1e-8 relative is ample for a variance quadratic form: a
            # tighter tol spends iterations without changing it
            X, info = solver.solve(
                jnp.asarray(B),
                tol=max(self._cg_tol, 1e-8),
                maxiter=self._cg_maxiter,
            )
            if info != 0:
                warnings.warn(
                    f"LargeScaleGP variance solve for query block "
                    f"{start}:{stop} stopped at iteration {info} without "
                    f"reaching tol={self._cg_tol:.1e} — the returned "
                    f"variances for these points may be inaccurate; "
                    f"raise cg_maxiter."
                )
            X = np.asarray(X, np.float64)
            quad[start:stop] = np.einsum(
                "ij,ji->i", Kqx, X[:, : stop - start]
            )
        if return_mean:
            return mu + self.mean_value, amp2 - quad
        return amp2 - quad

    # column-block width for the batched variance solves
    _DF64_VAR_COLS = 8

    def _get_df64_multi_solver(self):
        """Lazily-built multi-RHS df64 solver for the variance columns
        (hyperparameters are fixed for the instance's lifetime, so the
        compiled chunk is reusable across calls)."""
        solver = getattr(self, "_df64_msolver", None)
        if solver is not None:
            return solver
        from ..ops.solvers import Df64MultiSolver

        chunk = self._df64_chunk()
        if self._precond64 is not None:
            def M_multi64(R, U64, Cinv, dinv):
                return woodbury_apply(R, U64, dinv, Cinv, core_chol=False)

            solver = Df64MultiSolver(
                self._matmat64_pair, M=M_multi64, M_args=self._precond64,
                matmat_args=self._df64_op_args(),
                restart_every=chunk,
                **self._df64_fast_kwargs("matmat"),
            )
        else:
            solver = Df64MultiSolver(
                self._matmat64_pair,
                matmat_args=self._df64_op_args(),
                restart_every=chunk,
                **self._df64_fast_kwargs("matmat"),
            )
        self._df64_msolver = solver
        return solver

    # ------------------------------------------------------------------ #
    # mixed-precision iterative refinement
    # ------------------------------------------------------------------ #
    def _build_matvec64(self):
        """Float64 system matvec, compiled once — a single block-mapped
        program."""
        if getattr(self, "_matvec64", None) is not None:
            return
        f64 = jnp.float64
        x64 = jnp.asarray(self._x_host, f64)
        sig64 = jnp.asarray(self._sig_host, f64)
        th64 = jnp.asarray(self.hyperpars, f64)
        jitter = self._bk.amp2_host(self.hyperpars) * 1e-12
        noise64 = self._bk.noise_variance_host(self.hyperpars)
        n_pad = self._n_padded
        # f64 doubles every buffer: use a smaller row block than the f32
        # solve so the block covariance chunk stays small
        block = self.block_size
        while block > 1024 and n_pad % (block // 2) == 0:
            block //= 2
        n_blocks = n_pad // block

        def matvec64(v):
            x_blocks = x64.reshape(n_blocks, block, -1)

            def one_block(xb):
                return jnp.dot(
                    self._bk.rows(xb, x64, th64), v, precision=_HI
                )

            Kv = lax.map(one_block, x_blocks).reshape(n_pad)
            return Kv + (sig64 + noise64 + jitter) * v

        self._matvec64 = jax.jit(matvec64)

    def _host_matvec64(self, v) -> np.ndarray:
        """Float64 system matvec on the host (blocked numpy): the residual
        path when x64 is off. The |u|^2+|v|^2-2uv matmul form is safe here
        — f64 cancellation is ~1e-13 relative."""
        v = np.asarray(v, dtype=np.float64)
        h = np.asarray(self.hyperpars, dtype=np.float64)
        x64 = np.asarray(self._x_host, np.float64)
        out = np.empty(self._n_padded)
        B = min(self.block_size, 4096)
        for i in range(0, self._n_padded, B):
            blk = slice(i, min(i + B, self._n_padded))
            out[blk] = self._bk.rows_host64(x64[blk], x64, h) @ v
        diag = (
            self._sig_host
            + self._bk.noise_variance_host(h)
            + self._bk.amp2_host(h) * 1e-12
        )
        return out + diag * v

    def _residual64(self, alpha64, backend: str):
        if backend == "df64":
            # the df64 tier's matvec on an exact hi/lo split of alpha. A
            # residual evaluation needs ONE matvec per round — never
            # materialise the (n, n) stored entry pair just for that
            if not hasattr(self, "_us_hi"):
                stored = self.store_entries
                self.store_entries = False
                try:
                    self._prepare_df64()
                finally:
                    self.store_entries = stored
            ah = alpha64.astype(np.float32)
            al = (alpha64 - ah.astype(np.float64)).astype(np.float32)
            op = self._df64_op_args()
            return np.asarray(
                self._matvec64_pair(jnp.asarray(ah), *op)
                + self._matvec64_pair(jnp.asarray(al), *op)
            )
        if backend == "device":
            self._build_matvec64()
            return np.asarray(self._matvec64(jnp.asarray(alpha64)))
        return self._host_matvec64(alpha64)

    def refine(
        self,
        rounds: int = None,
        target: float = 1e-9,
        max_rounds: int = 40,
        residual_backend: str = "auto",
    ):
        """
        Mixed-precision iterative refinement of the training solve: the
        residual ``r = b - A alpha`` is evaluated in float64 (one compiled
        f64 matvec), the correction ``A d = r`` is solved with the existing
        float32 preconditioned CG, and ``alpha_64 += d``. Each round gains
        roughly a factor ``kappa * eps_32`` of accuracy, so a handful of
        rounds reach float64-level solves while all CG iterations stay in
        fast float32 — this cracks the small-noise regime (sigma ~ 1e-2 of
        the amplitude) where float32 CG alone cannot converge (alpha ~
        y / sigma^2 amplifies matvec rounding). Standard reference:
        Wilkinson-style iterative refinement.

        With ``rounds=None`` (default) refinement is adaptive: it stops
        when the float64 relative residual reaches ``target``, stagnates
        (per-round contraction worse than 0.9), or ``max_rounds`` is hit.

        :param residual_backend: where the f64 residual is evaluated —
            "device" (one compiled float64 matvec; requires
            ``jax_enable_x64``), "df64" (the df64 tier's matvec), "host"
            (blocked numpy), or "auto" (device when x64 is enabled, host
            otherwise).

        Returns ``self``; the refined solution is used for predictions
        (cast per-dtype) and is available in full precision as ``alpha64``.
        """
        residual_backend = self._resolve_residual_backend(residual_backend)
        if residual_backend == "device" and not jax.config.read(
            "jax_enable_x64"
        ):
            raise ValueError(
                "[ LargeScaleGP error ] refine(residual_backend='device') "
                "requires jax.config.update('jax_enable_x64', True)."
            )
        b64 = (np.asarray(self._y_host) - self.mean_value) * self._mask
        b_norm = float(np.linalg.norm(b64))
        # start from the full-precision iterate when one exists (df64
        # construction or an earlier refine): starting from the float32
        # cast would discard its accuracy and the best-so-far tracking
        # could then settle on a worse solution than it began with
        alpha64 = np.asarray(
            getattr(self, "alpha64", self.alpha), np.float64
        )
        solve_dtype = self._x.dtype
        n_rounds = max_rounds if rounds is None else rounds
        # refinement never returns a worse solution than it started with:
        # when the inner float32 CG is beyond its conditioning limit its
        # "corrections" can diverge, so the best-residual iterate is kept
        best_alpha, best_res = alpha64, np.inf
        last_res = np.inf
        for _ in range(n_rounds):
            r64 = (b64 - self._residual64(alpha64, residual_backend)) * self._mask
            res = float(np.linalg.norm(r64)) / max(b_norm, 1e-300)
            if res < best_res:
                best_alpha, best_res = alpha64, res
            if res <= target or (rounds is None and res > 0.9 * last_res):
                break
            last_res = res
            if self.solver == "df64":
                d = self._solve_rhs(jnp.asarray(r64))  # full f64 residual
            else:
                d = self._solve_rhs(jnp.asarray(r64.astype(solve_dtype)))
            alpha64 = alpha64 + np.asarray(d, np.float64)
        else:
            # all rounds ran: score the final iterate too
            r64 = (b64 - self._residual64(alpha64, residual_backend)) * self._mask
            res = float(np.linalg.norm(r64)) / max(b_norm, 1e-300)
            if res < best_res:
                best_alpha, best_res = alpha64, res
        self.alpha64 = best_alpha
        self.alpha = jnp.asarray(best_alpha, solve_dtype)
        return self

    def _resolve_residual_backend(self, residual_backend: str) -> str:
        """'auto' -> the exact compiled float64 matvec when x64 is on,
        blocked host numpy otherwise. ``refine()`` and
        ``residual_norm_f64`` must resolve identically or they would score
        the same iterate through different arithmetic."""
        if residual_backend != "auto":
            return residual_backend
        return "device" if jax.config.read("jax_enable_x64") else "host"

    def residual_norm_f64(self, residual_backend: str = "auto") -> float:
        """Relative residual of the (refined) solve, evaluated entirely in
        float64 — the honest convergence measure for small-noise problems
        where a float32 residual saturates at float32 rounding."""
        residual_backend = self._resolve_residual_backend(residual_backend)
        b64 = (np.asarray(self._y_host) - self.mean_value) * self._mask
        alpha = getattr(self, "alpha64", None)
        if alpha is None:
            alpha = np.asarray(self.alpha, np.float64)
        r = (b64 - self._residual64(alpha, residual_backend)) * self._mask
        return float(np.linalg.norm(r) / max(np.linalg.norm(b64), 1e-300))

    def residual_norm(self) -> float:
        """Relative residual of the training solve over the real (unpadded)
        rows — a CG convergence check."""
        rhs = (self._y - self.mean_value) * self._mask_dev
        r = (self._matvec(self.alpha) - rhs) * self._mask_dev
        return float(jnp.linalg.norm(r) / jnp.linalg.norm(rhs))
