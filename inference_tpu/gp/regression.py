"""Gaussian-process regression.

JAX rebuild of the reference ``GpRegressor``
(reference: inference/gp/regression.py:16-612). API parity: constructor
signature, ``__call__`` returning per-point means and standard deviations,
``gradient`` / ``spatial_derivatives`` / ``build_posterior`` /
``loo_predictions``, ``marginal_likelihood(_gradient)`` and
``loo_likelihood(_gradient)`` selectors, multistart L-BFGS-B or differential
evolution hyperparameter fitting. Key design changes:

- the marginal-likelihood / LOO objectives are **jitted scalar functions**
  and their hyperparameter gradients come from ``jax.value_and_grad``
  (differentiating through the Cholesky factorisation), replacing the
  reference's hand-derived ``Q = alpha alpha^T - K^-1`` trace identities
  (reference: regression.py:544-567) and the per-parameter dK matrices;
- prediction is **batched** over query points (one kernel-block matmul and
  triangular solve), replacing the reference's per-point Python loop
  (reference: regression.py:204-216);
- Cholesky failures are handled branchlessly: a non-finite factorisation
  pins the likelihood to a large negative floor so optimizers retreat
  (the reference catches LinAlgError and returns -1e50,
  reference: regression.py:536-542);
- ``n_processes`` is accepted for API compatibility but ignored — the
  device itself provides the intra-op parallelism that the reference gets
  from a multiprocessing pool.
"""

from copy import copy
from inspect import isclass
from warnings import warn

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular, cho_solve
from scipy.optimize import differential_evolution, fmin_l_bfgs_b

from .covariance import CovarianceFunction, SquaredExponential
from ..ops.linalg import identity_like
from .mean import MeanFunction, ConstantMean


# padded size from which the closed-form LML backward wins on the GPU
# (measured at N = 2,048, 8,192 and 16,384: 1.2-3.0x over the native
# factorisation's autodiff VJP and ahead of the blocked factor; PERF.md
# "Cholesky and LML backward variants"). Float64 only: in float32 its
# explicit K^-1 carries kappa * eps32 error into the gradient (measured
# 1.4e-1 relative at N = 16,384, against 5.6e-3 through autodiff).
_ANALYTIC_FROM_N = 2048


def auto_gradient_path(n: int, dtype) -> str:
    """The ``cholesky="auto"`` choice for the gradient programs (LML and
    LOO value+gradient) at padded size ``n`` and working ``dtype``: "xla"
    (native factorisation, autodiff VJP) or "analytic" (native forward,
    closed-form LML backward, float64 from n >= 2048)."""
    if jnp.dtype(dtype) == jnp.float64 and n >= _ANALYTIC_FROM_N:
        return "analytic"
    return "xla"


class GpRegressor:
    """
    Gaussian-process regression in any number of dimensions.

    :param x: \
        x-data as a 2D array of shape (n_points, n_dimensions), or any
        array-like convertible to one.

    :param y: \
        y-data values as a 1D array.

    :param y_err: \
        Optional standard deviations on the y-data (1D array).

    :param y_cov: \
        Optional full covariance matrix for the y-data (alternative to
        ``y_err``).

    :param hyperpars: \
        Optional hyperparameter values; when omitted they are selected by
        maximising the chosen model-selection objective.

    :param kernel: \
        Covariance-function class or instance (default SquaredExponential).

    :param mean: \
        Mean-function class or instance (default ConstantMean).

    :param cross_val: \
        Use leave-one-out cross-validation instead of the marginal
        likelihood for hyperparameter selection.

    :param optimizer: \
        "bfgs" (host multistart L-BFGS-B), "diffev" (differential
        evolution), or "device" (all starts optimised in parallel on
        device as one compiled program — see ``fit_device``).

    :param n_processes: \
        Accepted for API compatibility; optimisation runs serially against
        the accelerator.

    :param n_starts: \
        Number of L-BFGS-B starting positions.

    :param pad_to: \
        Optional bucket size for shape padding. The data is padded up to the
        next multiple of ``pad_to`` with masked rows (padded rows become
        identity rows of the covariance, contributing exactly zero to the
        likelihood), so models refit on growing datasets — e.g. the
        ``GpOptimiser`` loop — reuse their compiled programs instead of
        recompiling at every new data size. Results are numerically
        identical to the unpadded computation.

    :param cholesky: \
        Factorisation backend for the N x N training matrix: "xla"
        (``jnp.linalg.cholesky``), "blocked" (statically-unrolled matmul
        panels, ``ops.linalg.blocked_cholesky``), an int panel width for
        the blocked factor, "analytic" (native forward + closed-form
        LML backward ``Q = (alpha alpha^T - K^-1)/2`` via the blocked
        triangular inverse — R&W eq. 5.9, the same identity the
        reference evaluates on the host at
        inference/gp/regression.py:544-567), or "auto" (default): the
        native factorisation for forward-only programs, and for the
        gradient programs the path ``auto_gradient_path`` picks from the
        padded size and the dtype.
    """

    def __init__(
        self,
        x,
        y,
        y_err=None,
        y_cov=None,
        hyperpars=None,
        kernel: CovarianceFunction = SquaredExponential,
        mean: MeanFunction = ConstantMean,
        cross_val: bool = False,
        optimizer: str = "bfgs",
        n_processes: int = 1,
        n_starts: int = None,
        pad_to: int = None,
        dtype=None,
        cholesky="auto",
    ):
        # working dtype for the device arrays/compiled programs. The
        # default tracks jax x64 mode (float64 when it is enabled, float32
        # otherwise); pass dtype="float32" explicitly to keep a large-N
        # model in fast float32 under an x64-enabled process
        self._dtype = (
            jnp.dtype(dtype) if dtype is not None else None
        )
        if cholesky not in ("auto", "xla", "blocked", "analytic") and not (
            isinstance(cholesky, int)
            and not isinstance(cholesky, bool)
            and cholesky > 0
        ):
            raise ValueError(
                f"[ GpRegressor error ] 'cholesky' must be 'auto', 'xla', "
                f"'blocked', 'analytic' or a positive panel width (int), "
                f"but {cholesky!r} was given."
            )
        # factorisation backend for the N x N training matrix (see the
        # class docstring and _build_compiled_functions)
        self._cholesky = cholesky
        self.cov = kernel() if isclass(kernel) else kernel
        self.mean = mean() if isclass(mean) else mean
        # user-specified bounds persist across data updates; auto-estimated
        # bounds are recomputed from the data each time
        self._cov_bounds_user = self.cov.bounds is not None
        self._mean_bounds_user = getattr(self.mean, "bounds", None) is not None
        self.pad_to = pad_to

        self._ingest_data(x, y, y_err, y_cov)
        self._build_compiled_functions()

        self.cross_val = cross_val
        if cross_val:
            self.model_selector = self.loo_likelihood
            self.model_selector_gradient = self.loo_likelihood_gradient
        else:
            self.model_selector = self.marginal_likelihood
            self.model_selector_gradient = self.marginal_likelihood_gradient

        if hyperpars is None:
            hyperpars = self.fit(
                optimizer=optimizer, n_starts=n_starts, n_processes=n_processes
            )
        self.set_hyperparameters(hyperpars)

    # ------------------------------------------------------------------ #
    # data handling
    # ------------------------------------------------------------------ #
    def _ingest_data(self, x, y, y_err, y_cov):
        """Validate, pad and stage the training data (host and device)."""
        # data validation / reshaping (reference: regression.py:93-130)
        self.x = x if isinstance(x, np.ndarray) else np.array(x)
        self.y = np.asarray(y).squeeze()

        if self.y.ndim != 1:
            raise ValueError(
                f"[ GpRegressor error ] 'y' argument must be a 1D array, but "
                f"instead has shape {self.y.shape}"
            )

        self.n_points = self.y.size
        if self.x.ndim == 2:
            self.n_dimensions = self.x.shape[1]
        elif self.x.ndim <= 1:
            self.n_dimensions = 1
            self.x = self.x.reshape([self.x.size, 1])
        else:
            raise ValueError(
                f"[ GpRegressor error ] 'x' argument must be a 2D array, but "
                f"instead has {self.x.ndim} dimensions and shape {self.x.shape}."
            )

        if self.x.shape[0] != self.n_points:
            raise ValueError(
                f"[ GpRegressor error ] The first dimension of the 'x' array "
                f"must be equal in size to the 'y' array. 'x' has shape "
                f"{self.x.shape}, but 'y' has size {self.y.size}."
            )

        self.sig = self.check_error_data(y_err, y_cov)

        self.cov.pass_spatial_data(self.x)
        self.mean.pass_spatial_data(self.x)
        if not self._cov_bounds_user:
            self.cov.estimate_hyperpar_bounds(self.y)
        if not self._mean_bounds_user:
            self.mean.estimate_hyperpar_bounds(self.y)
        self.hp_bounds = copy(self.mean.bounds)
        self.hp_bounds.extend(copy(self.cov.bounds))

        # shape padding: bounds above were estimated from the real data;
        # the kernel/mean objects are now re-pointed at the padded arrays.
        # Padded x rows sit at the data centroid (keeps centred means exact)
        if self.pad_to is not None:
            self._n_padded = max(
                -(-self.n_points // self.pad_to) * self.pad_to, self.pad_to
            )
        else:
            self._n_padded = self.n_points
        n_extra = self._n_padded - self.n_points
        if n_extra > 0:
            centroid = self.x.mean(axis=0, keepdims=True)
            x_padded = np.concatenate(
                [self.x, np.repeat(centroid, n_extra, axis=0)], axis=0
            )
            y_padded = np.concatenate([self.y, np.zeros(n_extra)])
            n_params_before = self.cov.n_params
            self.cov.pass_spatial_data(x_padded)
            self.mean.pass_spatial_data(x_padded)
            if self.cov.n_params != n_params_before:
                # data-sized kernels (HeteroscedasticNoise) gain one
                # hyperparameter per PADDED row, inconsistent with the
                # bounds built from the real data — shape padding cannot
                # be combined with them
                raise ValueError(
                    "[ GpRegressor error ] 'pad_to' cannot be used with "
                    "data-sized kernels such as HeteroscedasticNoise "
                    "(their hyperparameter count would track the padded "
                    "shape); construct with pad_to=None."
                )
        else:
            x_padded = self.x
            y_padded = self.y
        mask = np.zeros(self._n_padded)
        mask[: self.n_points] = 1.0
        self._x_padded = x_padded
        self._y_padded = y_padded
        self._mask = mask

        self.n_hyperpars = len(self.hp_bounds)
        self.mean_slice = slice(0, self.mean.n_params)
        self.cov_slice = slice(self.mean.n_params, self.n_hyperpars)
        self.hyperpar_labels = [*self.mean.hyperpar_labels, *self.cov.hyperpar_labels]

        # device copies; diagonal error models keep only the variance vector
        # on device (the dense matrix would cost O(N^2) memory and
        # compile-payload size at large N)
        dt = self._dtype
        self._x_dev = jnp.asarray(self._x_padded, dt)
        self._y_dev = jnp.asarray(self._y_padded, dt)
        self._mask_dev = jnp.asarray(self._mask, dt)
        if self._sig_is_diag:
            sig_diag = np.zeros(self._n_padded)
            sig_diag[: self.n_points] = np.diagonal(self.sig)
            self._sig_dev = jnp.asarray(sig_diag, dt)
        else:
            sig_full = np.zeros([self._n_padded, self._n_padded])
            sig_full[: self.n_points, : self.n_points] = self.sig
            self._sig_dev = jnp.asarray(sig_full, dt)

    def update_data(self, x, y, y_err=None, y_cov=None, set_state=True):
        """
        Replace the training data without rebuilding the model. All compiled
        programs take the data as runtime arguments, so when the padded
        shape is unchanged (``pad_to`` buckets) a refit on updated data
        reuses every compilation — this is what makes the ``GpOptimiser``
        loop cheap. Hyperparameters are NOT refit automatically: call
        ``fit``/``set_hyperparameters`` afterwards. ``set_state=False``
        skips the interim Cholesky/alpha recomputation at the old
        hyperparameters (one device dispatch) — for callers that refit
        immediately afterwards (the GpOptimiser's fused iteration).
        """
        old_n_hyperpars = self.n_hyperpars
        old_sig_is_diag = self._sig_is_diag
        self._ingest_data(x, y, y_err, y_cov)
        if self.n_hyperpars != old_n_hyperpars:
            raise ValueError(
                f"[ GpRegressor error ] 'update_data' changed the number of "
                f"hyperparameters ({old_n_hyperpars} -> {self.n_hyperpars}); "
                f"this happens with data-sized kernels such as "
                f"HeteroscedasticNoise. This instance's data state has "
                f"already been replaced and is now inconsistent with its "
                f"hyperparameters — discard it and construct a new "
                f"GpRegressor."
            )
        if self._sig_is_diag != old_sig_is_diag:
            # the error-model structure changed (y_err <-> y_cov): the
            # traced programs are specialised on it, so rebuild them —
            # including the cached device multistart solvers, whose
            # closures capture the old objective
            self._compiled_built = False
            self._build_compiled_functions()
            self._fit_ms_cache = {}
        if set_state and getattr(self, "hyperpars", None) is not None:
            self.set_hyperparameters(self.hyperpars)
        else:
            # L/alpha still reflect the old data (same padded shape, so
            # nothing would fail loudly); block predictions until a
            # refit/set_hyperparameters settles the state
            self._state_stale = True

    def _require_current_state(self):
        if getattr(self, "_state_stale", False):
            raise RuntimeError(
                "[ GpRegressor error ] predictions requested while the "
                "factorisation state (L, alpha) is stale: 'update_data' "
                "was called with set_state=False and no "
                "'set_hyperparameters' / refit has run since. Call "
                "'set_hyperparameters' (or fit) before predicting."
            )

    def fit(self, optimizer: str = "bfgs", n_starts: int = None,
            n_processes: int = 1):
        """Select hyperparameters by maximising the model-selection
        objective; returns the optimised vector (does not set it)."""
        if optimizer not in ["bfgs", "diffev", "device"]:
            optimizer = "bfgs"
            warn(
                "An invalid option was passed to the 'optimizer' keyword "
                "argument. The default option 'bfgs' was used instead. "
                "Valid options are 'bfgs', 'diffev' and 'device'."
            )
        if optimizer == "diffev":
            return self.differential_evo()
        if optimizer == "device":
            return self.fit_device(starts=n_starts if n_starts is not None else 16)
        return self.multistart_bfgs(n_processes=n_processes, starts=n_starts)

    # ------------------------------------------------------------------ #
    # compiled objectives and predictors
    # ------------------------------------------------------------------ #
    def _build_compiled_functions(self):
        if getattr(self, "_compiled_built", False):
            return
        cov, mean = self.cov, self.mean
        mean_slc, cov_slc = self.mean_slice, self.cov_slice

        # ALL data (x, y, the error covariance 'sig', the padding mask) is
        # passed as runtime arguments rather than captured in closures:
        # captured arrays are baked into the compiled program as constants.
        # Large constants blow up the compiled program (an N x N constant
        # is embedded in it at full size); small ones are inlined as
        # literals, which changes the program hash on every data update and
        # defeats compilation reuse across ``update_data`` refits.

        sig_is_diag = self._sig_is_diag

        from ..ops.linalg import blocked_cholesky

        def make_blocked(blk):
            return lambda K: blocked_cholesky(K, block=blk)

        n_pad = int(self._x_dev.shape[0])
        grad_path = self._cholesky
        if grad_path == "auto":
            grad_path = auto_gradient_path(n_pad, self._x_dev.dtype)
        if self._cholesky == "auto":
            chol_fwd = jnp.linalg.cholesky
            chol_grad = (
                make_blocked(2048)
                if grad_path == "blocked"
                else jnp.linalg.cholesky
            )
        elif self._cholesky in ("xla", "analytic"):
            # "analytic" replaces the LML gradient's backward pass
            # entirely (see make_lml_analytic below); the factorisations
            # that remain (forward paths, the LOO objective) use the
            # expander
            chol_fwd = chol_grad = jnp.linalg.cholesky
        else:
            blk = self._cholesky if isinstance(self._cholesky, int) else 2048
            chol_fwd = chol_grad = make_blocked(blk)
        def add_sig(K, sig):
            if sig_is_diag:
                return K + jnp.diag(sig)
            return K + sig

        def apply_mask(K, m):
            """Padded (masked-out) rows/columns become identity rows of K,
            decoupling them: they contribute exactly zero to the quadratic
            form and the log-determinant. With an all-ones mask this is the
            identity operation."""
            from ..ops.linalg import add_diagonal

            return add_diagonal(K * (m[:, None] * m[None, :]), 1.0 - m)

        def make_lml(chol):
            def lml(theta, x, y, sig, m, jitter=0.0):
                K = apply_mask(add_sig(cov.matrix(x, theta[cov_slc]), sig), m)
                # fit-path-only relative jitter (jitter=0 on the exact/parity
                # paths): in float32 a BFGS line search probing extreme
                # hyperparameters makes K numerically singular, and the NaN
                # factorisation poisons gradients (0 * NaN) — a tiny
                # trace-scaled shift keeps the whole fit finite
                K = K + (jitter * jnp.diagonal(K).mean()) * identity_like(K)
                mu = mean.vector(x, theta[mean_slc])
                L = chol(K)
                ok = jnp.isfinite(L).all()
                L_safe = jnp.where(ok, L, identity_like(L))
                v = solve_triangular(L_safe, (y - mu) * m, lower=True)
                value = -0.5 * (v @ v) - jnp.log(jnp.diagonal(L_safe)).sum()
                # likelihood floor for failed factorisations; kept inside
                # the dtype's finite range (-1e50 overflows float32)
                floor = jnp.asarray(jnp.finfo(K.dtype).min / 4, K.dtype)
                return jnp.where(ok, value, floor)

            return lml

        def make_loo(chol, tril_iK=False):
            """LOO objective. With ``tril_iK`` the full K^-1 its forward
            needs (per-point LOO variances are 1/diag(K^-1)) is built by
            the blocked triangular inverse + gram product instead of
            ``cho_solve`` of an identity — autodiff then flows through
            plain matmuls (``benchmarks/loo_grad_experiment.py``)."""
            from ..ops.linalg import blocked_tril_inverse, tril_gram

            def loo(theta, x, y, sig, m, jitter=0.0):
                K = apply_mask(add_sig(cov.matrix(x, theta[cov_slc]), sig), m)
                K = K + (jitter * jnp.diagonal(K).mean()) * identity_like(K)
                mu = mean.vector(x, theta[mean_slc])
                L = chol(K)
                ok = jnp.isfinite(L).all()
                L_safe = jnp.where(ok, L, identity_like(L))
                if tril_iK:
                    blk = 2048 * max(1, -(-L.shape[0] // (8 * 2048)))
                    iK = tril_gram(
                        blocked_tril_inverse(L_safe, block=blk), block=blk
                    )
                else:
                    iK = cho_solve((L_safe, True), identity_like(L))
                alpha = iK @ ((y - mu) * m)
                var = 1.0 / jnp.diagonal(iK)
                value = -0.5 * (var * alpha**2 + jnp.log(var)).sum()
                # likelihood floor for failed factorisations; kept inside
                # the dtype's finite range (-1e50 overflows float32)
                floor = jnp.asarray(jnp.finfo(K.dtype).min / 4, K.dtype)
                return jnp.where(ok, value, floor)

            return loo

        def make_lml_analytic():
            """LML with a closed-form backward pass: the gradient w.r.t.
            the covariance matrix is ``Q = (alpha alpha^T - K^-1) / 2``
            (R&W eq. 5.9 — the identity the reference evaluates on the
            host, inference/gp/regression.py:544-567), so instead of
            autodiffing through the factorisation the backward computes
            ``K^-1 = L^-T L^-1`` with the blocked triangular inverse +
            triangular gram product — pure HIGHEST-precision matmuls,
            the same n^3 model flops as the Cholesky VJP — and delegates
            the pullback to every input (hyperparameters, data, noise,
            mask, jitter) to the assembly VJP. The forward factorisation
            is the native one."""
            from ..ops.linalg import blocked_tril_inverse, tril_gram

            def assemble(theta, x, y, sig, m, jitter):
                K = apply_mask(
                    add_sig(cov.matrix(x, theta[cov_slc]), sig), m
                )
                K = K + (jitter * jnp.diagonal(K).mean()) * identity_like(K)
                mu = mean.vector(x, theta[mean_slc])
                return K, (y - mu) * m

            def forward(theta, x, y, sig, m, jitter):
                K, r = assemble(theta, x, y, sig, m, jitter)
                L = jnp.linalg.cholesky(K)
                ok = jnp.isfinite(L).all()
                L_safe = jnp.where(ok, L, identity_like(L))
                v = solve_triangular(L_safe, r, lower=True)
                value = -0.5 * (v @ v) - jnp.log(
                    jnp.diagonal(L_safe)
                ).sum()
                floor = jnp.asarray(jnp.finfo(K.dtype).min / 4, K.dtype)
                return jnp.where(ok, value, floor), L_safe, v, ok

            @jax.custom_vjp
            def core(theta, x, y, sig, m, jitter):
                return forward(theta, x, y, sig, m, jitter)[0]

            def fwd(theta, x, y, sig, m, jitter):
                value, L, v, ok = forward(theta, x, y, sig, m, jitter)
                return value, (theta, x, y, sig, m, jitter, L, v, ok)

            def bwd(res, g):
                theta, x, y, sig, m, jitter, L, v, ok = res
                alpha = solve_triangular(L.T, v, lower=False)
                # panel width: keep the statically-unrolled inverse/gram
                # at <= 8 block rows (~130 unrolled matmuls) so its
                # compilation stays bounded at large n
                n = L.shape[0]
                blk = 2048 * max(1, -(-n // (8 * 2048)))
                X = blocked_tril_inverse(L, block=blk)
                iK = tril_gram(X, block=blk)
                Q = 0.5 * (jnp.outer(alpha, alpha) - iK)
                # the value depends on the inputs only through (K, r):
                # dL/dK = Q and dL/dr = -alpha, so the assembly VJP gives
                # every input's cotangent (unused ones are dead code
                # under jit)
                _, pull = jax.vjp(assemble, theta, x, y, sig, m, jitter)
                return tuple(
                    jnp.where(ok, c, jnp.zeros_like(c)) * g
                    for c in pull((Q, -alpha))
                )

            core.defvjp(fwd, bwd)

            def lml(theta, x, y, sig, m, jitter=0.0):
                # keyword-free core: custom_vjp functions reject kwargs
                return core(theta, x, y, sig, m, jitter)

            return lml

        # raw (unjitted) objectives kept for composition into larger
        # compiled programs — those all differentiate the objective
        # (vmapped multistart fit), so they carry the gradient-path factor.
        use_analytic = grad_path == "analytic"
        self._lml_raw = (
            make_lml_analytic() if use_analytic else make_lml(chol_grad)
        )
        self._loo_raw = make_loo(chol_grad, tril_iK=use_analytic)

        # value-only public entry points use the forward-path factor;
        # gradient programs use the gradient-path factor chosen above
        lml_jit = jax.jit(make_lml(chol_fwd))
        lml_grad_jit = jax.jit(jax.value_and_grad(self._lml_raw, argnums=0))
        loo_jit = jax.jit(make_loo(chol_fwd))
        loo_grad_jit = jax.jit(jax.value_and_grad(self._loo_raw, argnums=0))

        def data_args(self):
            return (self._x_dev, self._y_dev, self._sig_dev, self._mask_dev)

        self._lml = lambda theta: lml_jit(theta, *data_args(self))
        self._lml_grad = lambda theta: lml_grad_jit(theta, *data_args(self))
        self._loo = lambda theta: loo_jit(theta, *data_args(self))
        self._loo_grad = lambda theta: loo_grad_jit(theta, *data_args(self))

        def fit_state(theta, x, y, sig, m):
            """K_xx, mean, Cholesky factor and alpha for given
            hyperparameters — one compiled program."""
            K_xx = apply_mask(add_sig(cov.matrix(x, theta[cov_slc]), sig), m)
            mu = mean.vector(x, theta[mean_slc])
            L = chol_fwd(K_xx)
            alpha = solve_triangular(
                L.T, solve_triangular(L, (y - mu) * m, lower=True)
            )
            return K_xx, mu, L, alpha

        fit_state_jit = jax.jit(fit_state)
        self._fit_state = lambda theta: fit_state_jit(theta, *data_args(self))
        # raw (unjitted) form kept for composition into fused programs
        # (the GpOptimiser's single-dispatch iteration)
        self._fit_state_raw = fit_state

        def predict(q, x, L, alpha, cov_pars, mean_pars, m):
            K_qx = cov(q, x, cov_pars) * m[None, :]
            # full float32 precision (no TF32 rounding)
            mu_q = jnp.dot(
                K_qx, alpha, precision=jax.lax.Precision.HIGHEST
            ) + jax.vmap(lambda p: mean.point(p, mean_pars, x))(q)
            v = solve_triangular(L, K_qx.T, lower=True)
            kqq = jax.vmap(
                lambda p: cov(p[None, :], p[None, :], cov_pars)[0, 0]
            )(q)
            var = kqq - (v**2).sum(axis=0)
            return mu_q, jnp.sqrt(jnp.abs(var))

        self._predict = jax.jit(predict)

        def predict_single(q, x, L, alpha, cov_pars, mean_pars, m):
            K_qx = cov(q[None, :], x, cov_pars)[0] * m
            mu = jnp.dot(
                K_qx, alpha, precision=jax.lax.Precision.HIGHEST
            ) + mean.point(q, mean_pars, x)
            v = solve_triangular(L, K_qx, lower=True)
            kqq = cov(q[None, :], q[None, :], cov_pars)[0, 0]
            var = kqq - v @ v
            return mu, var

        self._predict_single = predict_single

        def grad_single(q, x, L, alpha, cov_pars, mean_pars, m):
            """Mean vector and covariance matrix of the GP gradient."""
            k_vec = lambda qq: cov(qq[None, :], x, cov_pars)[0] * m
            dK = jax.jacfwd(k_vec)(q)  # (N, D)
            dmu = dK.T @ alpha + jax.grad(
                lambda qq: mean.point(qq, mean_pars, x) + 0.0
            )(q)
            pair = lambda q1, q2: cov(q1[None, :], q2[None, :], cov_pars)[0, 0]
            R = jax.jacfwd(jax.grad(pair, argnums=0), argnums=1)(q, q)
            Q = solve_triangular(L, dK, lower=True)
            covariance = R - Q.T @ Q
            return dmu, covariance

        self._grad_single = jax.jit(grad_single)

        def spatial_derivs_single(q, x, L, alpha, cov_pars, mean_pars, m):
            mu_fn = lambda qq: predict_single(
                qq, x, L, alpha, cov_pars, mean_pars, m
            )[0]
            var_fn = lambda qq: predict_single(
                qq, x, L, alpha, cov_pars, mean_pars, m
            )[1]
            return jax.grad(mu_fn)(q), jax.grad(var_fn)(q)

        self._spatial_derivs_single = jax.jit(spatial_derivs_single)
        self._compiled_built = True
        self._compiled_sig_is_diag = sig_is_diag

    # ------------------------------------------------------------------ #
    # state
    # ------------------------------------------------------------------ #
    def set_hyperparameters(self, hyperpars):
        """Update the hyperparameter values of the model."""
        hyperpars = np.asarray(hyperpars, dtype=float)
        if hyperpars.size != self.n_hyperpars:
            raise ValueError(
                f"[ GpRegressor error ] An incorrect number of hyper-parameter "
                f"values were passed via the 'hyperpars' keyword argument: "
                f"there are {self.n_hyperpars} hyper-parameters but "
                f"{hyperpars.size} values were given."
            )
        self.hyperpars = hyperpars
        self.mean_hyperpars = self.hyperpars[self.mean_slice]
        self.cov_hyperpars = self.hyperpars[self.cov_slice]
        theta = jnp.asarray(hyperpars, self._x_dev.dtype)
        K_xx, mu, L, alpha = self._fit_state(theta)
        self.K_xx = K_xx
        self.mu = mu
        self.L = L
        self.alpha = alpha
        self._cov_pars_dev = theta[self.cov_slice]
        self._mean_pars_dev = theta[self.mean_slice]
        self._state_stale = False

    def check_error_data(self, y_err, y_cov):
        self._sig_is_diag = y_cov is None
        if y_cov is not None:
            if type(y_cov) in (list, tuple):
                y_cov = np.array(y_cov).squeeze()
            elif not isinstance(y_cov, np.ndarray):
                raise TypeError(
                    f"[ GpRegressor error ] The 'y_cov' keyword argument should "
                    f"be given as a numpy array: expected {np.ndarray} but "
                    f"{type(y_cov)} was given."
                )
            if y_cov.shape != (self.n_points, self.n_points):
                raise ValueError(
                    "[ GpRegressor error ] 'y_cov' must be a 2D array of shape "
                    "(N, N), where N is the number of given y-data values."
                )
            if not (y_cov == y_cov.T).all():
                raise ValueError(
                    "[ GpRegressor error ] The covariance matrix passed to the "
                    "'y_cov' keyword argument is not symmetric."
                )
            if y_err is not None:
                warn(
                    "[ GpRegressor warning ] Only one of the 'y_err' and "
                    "'y_cov' keyword arguments should be specified. Only the "
                    "input to 'y_cov' will be used - the input to 'y_err' "
                    "will be ignored."
                )
            return y_cov

        if y_err is not None:
            if type(y_err) in (list, tuple):
                y_err = np.array(y_err).squeeze()
            elif not isinstance(y_err, np.ndarray):
                raise TypeError(
                    f"[ GpRegressor error ] The 'y_err' keyword argument should "
                    f"be given as a numpy array: expected {np.ndarray} but "
                    f"{type(y_err)} was given."
                )
            if y_err.shape != (self.n_points,):
                raise ValueError(
                    "[ GpRegressor error ] 'y_err' must be a 1D array of length "
                    "N, where N is the number of given y-data values."
                )
            return np.diag(y_err**2)

        return np.zeros([self.n_points, self.n_points])

    def process_points(self, points) -> np.ndarray:
        x = points if isinstance(points, np.ndarray) else np.array(points)

        if x.ndim <= 1 and self.n_dimensions == 1:
            x = x.reshape([x.size, 1])
        elif x.ndim == 1 and x.size == self.n_dimensions:
            x = x.reshape([1, x.size])
        elif x.ndim > 2:
            raise ValueError(
                f"[ GpRegressor error ] 'points' argument must be a 2D array, "
                f"but given array has {x.ndim} dimensions and shape {x.shape}."
            )

        if x.shape[1] != self.n_dimensions:
            raise ValueError(
                f"[ GpRegressor error ] The second dimension of the 'points' "
                f"array must have size equal to the number of dimensions of "
                f"the input data. The input data have {self.n_dimensions} "
                f"dimensions but 'points' has shape {x.shape}."
            )
        return x

    # ------------------------------------------------------------------ #
    # prediction
    # ------------------------------------------------------------------ #
    def __call__(self, points):
        """
        Predictive means and standard deviations at the given points,
        computed in a single batched device call.
        """
        self._require_current_state()
        p = jnp.asarray(self.process_points(points), self._x_dev.dtype)
        mu, sig = self._predict(
            p,
            self._x_dev,
            self.L,
            self.alpha,
            self._cov_pars_dev,
            self._mean_pars_dev,
            self._mask_dev,
        )
        return np.asarray(mu), np.asarray(sig)

    def gradient(self, points):
        """
        Mean and covariance of the gradient of the regression estimate at
        the given points. Derivative kernels come from autodiff of the
        covariance function, so this works for **all** kernels (the
        reference only supports SquaredExponential here).
        """
        self._require_current_state()
        p = jnp.asarray(self.process_points(points), self._x_dev.dtype)
        mu_g, cov_g = jax.vmap(
            lambda q: self._grad_single(
                q,
                self._x_dev,
                self.L,
                self.alpha,
                self._cov_pars_dev,
                self._mean_pars_dev,
                self._mask_dev,
            )
        )(p)
        return np.asarray(mu_g).squeeze(), np.asarray(cov_g).squeeze()

    def spatial_derivatives(self, points):
        """
        Gradients of the predictive mean and variance at the given points,
        via autodiff of the predictors.
        """
        self._require_current_state()
        p = jnp.asarray(self.process_points(points), self._x_dev.dtype)
        dmu, dvar = jax.vmap(
            lambda q: self._spatial_derivs_single(
                q,
                self._x_dev,
                self.L,
                self.alpha,
                self._cov_pars_dev,
                self._mean_pars_dev,
                self._mask_dev,
            )
        )(p)
        return np.asarray(dmu).squeeze(), np.asarray(dvar).squeeze()

    def build_posterior(self, points, mean_only=False):
        """
        Full posterior mean vector (and covariance matrix) at the given
        points.
        """
        self._require_current_state()
        v = jnp.asarray(self.process_points(points), self._x_dev.dtype)
        K_qx = self.cov(v, self._x_dev, self._cov_pars_dev) * self._mask_dev[None, :]
        mu = K_qx @ self.alpha + jax.vmap(
            lambda p: self.mean(p, self._mean_pars_dev)
        )(v)
        if mean_only:
            return np.asarray(mu)
        K_qq = self.cov(v, v, self._cov_pars_dev)
        Q = solve_triangular(self.L, K_qx.T, lower=True)
        sigma = K_qq - (Q.T @ Q)
        return np.asarray(mu), np.asarray(sigma)

    def loo_predictions(self):
        """
        Leave-one-out predictions for each data point
        (Rasmussen & Williams eq. 5.12).
        """
        self._require_current_state()
        iK = cho_solve((self.L, True), identity_like(self.L))
        var = 1.0 / jnp.diagonal(iK)
        alpha = iK @ ((self._y_dev - self.mu) * self._mask_dev)
        mu = self._y_dev - alpha * var
        n = self.n_points
        return np.asarray(mu)[:n], np.asarray(jnp.sqrt(var))[:n]

    # ------------------------------------------------------------------ #
    # model-selection objectives
    # ------------------------------------------------------------------ #
    def marginal_likelihood(self, theta) -> float:
        """Log-marginal likelihood (Rasmussen & Williams eq. 5.8)."""
        return float(self._lml(jnp.asarray(theta, self._x_dev.dtype)))

    def marginal_likelihood_gradient(self, theta):
        """LML and its hyperparameter gradient via ``jax.value_and_grad``
        (replacing R&W eq. 5.9 trace identities with autodiff through the
        Cholesky factorisation)."""
        value, grad = self._lml_grad(jnp.asarray(theta, self._x_dev.dtype))
        return float(value), np.asarray(grad)

    def loo_likelihood(self, theta) -> float:
        """Leave-one-out log-likelihood (R&W eqs. 5.10-5.12)."""
        return float(self._loo(jnp.asarray(theta, self._x_dev.dtype)))

    def loo_likelihood_gradient(self, theta):
        """LOO likelihood and gradient via autodiff."""
        value, grad = self._loo_grad(jnp.asarray(theta, self._x_dev.dtype))
        return float(value), np.asarray(grad)

    # ------------------------------------------------------------------ #
    # hyperparameter optimisation
    # ------------------------------------------------------------------ #
    def differential_evo(self):
        opt_result = differential_evolution(
            func=lambda x: -self.model_selector(x), bounds=self.hp_bounds
        )
        return opt_result.x

    def bfgs_cost_func(self, theta):
        y, grad_y = self.model_selector_gradient(theta)
        return -y, -np.asarray(grad_y, dtype=float)

    def launch_bfgs(self, x0):
        return fmin_l_bfgs_b(
            func=self.bfgs_cost_func, x0=x0, approx_grad=False, bounds=self.hp_bounds
        )

    def fit_device(self, starts: int = 16, seed: int = 0, polish="device"):
        """
        Hyperparameter fit run as a single compiled device program.

        ``starts`` BFGS optimisations of the model-selection objective (LML,
        or LOO likelihood when ``cross_val=True``) run in parallel on device
        via ``vmap`` over ``jax.scipy.optimize.minimize``. Box bounds are
        enforced by a sigmoid reparameterisation of the hyperparameters, so
        the inner optimiser is unconstrained. The winning start is then
        refined by a second, tighter-tolerance device BFGS — the whole fit
        is two device dispatches and zero host optimiser loops.

        This replaces the reference's serial host multistart
        (reference: inference/gp/regression.py:482-504) with one device
        dispatch: the host loop pays a device round-trip per objective
        evaluation, while the device multistart pays one.

        :param starts: number of parallel starting positions.
        :param seed: RNG seed for the start positions.
        :param polish: "device" (default) refines the winner with a second
            on-device BFGS; "host" (or True) runs one host L-BFGS-B from
            the winner; False/None skips refinement.
        :return: the optimised hyperparameter vector (numpy array).
        """
        lwr = np.array([b[0] for b in self.hp_bounds], dtype=float)
        upr = np.array([b[1] for b in self.hp_bounds], dtype=float)
        solve_batch, fused, _ = self._fit_multistart_parts(starts)

        # start positions: uniform in the middle 90% of the box (in sigmoid
        # coordinates, logit of the box fraction), plus the box centre (z=0)
        rng = np.random.default_rng(seed)
        u = rng.uniform(0.05, 0.95, size=(max(starts - 1, 0), self.n_hyperpars))
        z0 = np.concatenate([np.log(u / (1 - u)), np.zeros((1, self.n_hyperpars))])

        data = (self._x_dev, self._y_dev, self._sig_dev, self._mask_dev)
        # the start/bound operands must match the working dtype: under
        # jax_enable_x64 a bare asarray traces them as float64, promoting
        # theta and with it the whole objective (Cholesky included) to
        # f64 — exactly what dtype="float32" exists to avoid
        wd = self._x_dev.dtype
        if polish == "device":
            _, _, z_best = fused(
                jnp.asarray(z0, wd), jnp.asarray(lwr, wd),
                jnp.asarray(upr, wd), *data
            )
            theta = lwr + (upr - lwr) / (1.0 + np.exp(-np.asarray(z_best)))
        else:
            zs, fs = solve_batch(
                jnp.asarray(z0, wd), jnp.asarray(lwr, wd),
                jnp.asarray(upr, wd), *data
            )
            zs, fs = np.asarray(zs), np.asarray(fs)
            best = int(np.nanargmin(np.where(np.isfinite(fs), fs, np.inf)))
            theta = lwr + (upr - lwr) / (1.0 + np.exp(-zs[best]))
            if polish in ("host", True):
                theta, _, _ = self.launch_bfgs(theta)
        return np.asarray(theta, dtype=float)

    def _fit_multistart_parts(self, starts: int):
        """Compiled + raw pieces of the device multistart hyperparameter
        fit: ``(jit(vmapped solve), jit(solve_and_refine), raw
        solve_and_refine)``. The raw form composes into larger fused
        programs (the GpOptimiser's one-dispatch iteration). Cached per
        start count; bounds and data are runtime arguments so the compiled
        solvers are reused across ``update_data`` refits."""
        from jax.scipy.optimize import minimize as _jax_minimize

        cache = getattr(self, "_fit_ms_cache", None)
        if cache is None:
            cache = self._fit_ms_cache = {}
        parts = cache.get(starts)
        if parts is not None:
            return parts

        obj = self._loo_raw if self.cross_val else self._lml_raw
        # in float32 the exact objective is not BFGS-safe (singular
        # factorisations at extreme hyperparameters poison gradients);
        # a trace-relative jitter keeps the whole search finite. The
        # float64 path keeps the exact objective.
        fit_jitter = 1e-6 if self._x_dev.dtype == jnp.float32 else 0.0

        def neg(z, lo, hi, x, y, sig, m):
            theta = lo + (hi - lo) * jax.nn.sigmoid(z)
            return -obj(theta, x, y, sig, m, jitter=fit_jitter)

        def solve_one(z0, lo, hi, x, y, sig, m):
            res = _jax_minimize(
                neg, z0, args=(lo, hi, x, y, sig, m), method="BFGS",
                options={"maxiter": 250},
            )
            # a diverged line search can return NaN iterates: score
            # them out rather than letting NaN win the argmin
            z_ok = jnp.isfinite(res.x).all()
            z = jnp.where(z_ok, res.x, z0)
            f = jnp.where(z_ok & jnp.isfinite(res.fun), res.fun, jnp.inf)
            return z, f

        def solve_and_refine(z0, lo, hi, x, y, sig, m):
            """All starts + winner refinement in ONE device program:
            the winner never round-trips through the host."""
            zs, fs = jax.vmap(
                solve_one, in_axes=(0,) + (None,) * 6
            )(z0, lo, hi, x, y, sig, m)
            best = jnp.argmin(fs)  # solve_one already mapped NaN -> inf
            # if every start failed, fall back to the box centre
            z_start = jnp.where(
                jnp.isfinite(fs[best]), zs[best], jnp.zeros_like(zs[best])
            )
            res = _jax_minimize(
                neg, z_start, args=(lo, hi, x, y, sig, m),
                method="BFGS", options={"maxiter": 500, "gtol": 1e-8},
            )
            improved = (res.fun <= fs[best]) & jnp.isfinite(res.x).all()
            z_best = jnp.where(improved, res.x, z_start)
            return zs, fs, z_best

        parts = (
            jax.jit(jax.vmap(solve_one, in_axes=(0,) + (None,) * 6)),
            jax.jit(solve_and_refine),
            solve_and_refine,
        )
        cache[starts] = parts
        return parts

    def multistart_bfgs(self, starts: int = None, n_processes: int = 1):
        if starts is None:
            starts = int(2 * np.sqrt(len(self.hp_bounds))) + 1
        lwr, upr = [np.array([k[i] for k in self.hp_bounds]) for i in [0, 1]]
        rng = np.random.default_rng()
        starting_positions = [
            lwr + (upr - lwr) * rng.random(size=len(self.hp_bounds))
            for _ in range(max(starts - 1, 0))
        ]
        starting_positions.append(0.5 * (lwr + upr))

        # n_processes is ignored: each objective evaluation is a compiled
        # device program, so the starts run serially on the host
        results = [self.launch_bfgs(x0) for x0 in starting_positions]
        solution = sorted(results, key=lambda x: x[1])[0][0]
        return solution

    def __str__(self):
        pad = max(len(label) for label in self.hyperpar_labels) + 2
        strings = ["\n[ GpRegressor hyperparameters ]\n"]
        for label, val in zip(self.hyperpar_labels, self.hyperpars):
            strings.append(f"{label:>{pad}} = {val:.4}\n")
        return "".join(strings)
