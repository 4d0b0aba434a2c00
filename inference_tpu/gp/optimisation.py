"""Gaussian-process (Bayesian) optimisation.

JAX rebuild of the reference ``GpOptimiser``
(reference: inference/gp/optimisation.py:14-292) with the same API:
``propose_evaluation`` maximises the acquisition by multistart BFGS with
autodiff gradients (or differential evolution), ``add_evaluation`` appends
the new datum and refits the GP from scratch, and ``plot_results`` shows the
convergence history.
"""

from collections.abc import Sequence
from inspect import isclass

import numpy as np
from scipy.optimize import differential_evolution, fmin_l_bfgs_b

from .regression import GpRegressor
from .covariance import CovarianceFunction, SquaredExponential
from .acquisition import AcquisitionFunction, ExpectedImprovement
from .mean import MeanFunction, ConstantMean


class GpOptimiser:
    """
    Gaussian-process optimisation in one or more dimensions, for objective
    functions that are expensive to evaluate.

    :param x: initial evaluation positions, shape (n_points, n_dims).
    :param y: objective values at ``x``.
    :param bounds: iterable of (lower, upper) tuples per dimension.
    :param y_err: optional Gaussian errors on the y values.
    :param hyperpars: optional fixed hyperparameter values.
    :param kernel: covariance-function class or instance.
    :param mean: mean-function class or instance.
    :param cross_val: use LOO-CV instead of marginal likelihood.
    :param acquisition: acquisition-function class or instance
        (default ExpectedImprovement).
    :param optimizer: "bfgs" (host multistart L-BFGS-B), "diffev"
        (differential evolution), or "device" (all starts optimised in
        parallel on device via a vmapped BFGS, one dispatch per proposal —
        the fast path on an accelerator).
    :param n_processes: accepted for API compatibility (runs serially
        against the accelerator).
    """

    def __init__(
        self,
        x,
        y,
        bounds: Sequence,
        y_err=None,
        hyperpars=None,
        kernel: CovarianceFunction = SquaredExponential,
        mean: MeanFunction = ConstantMean,
        cross_val: bool = False,
        acquisition: AcquisitionFunction = ExpectedImprovement,
        optimizer: str = "bfgs",
        n_processes: int = 1,
    ):
        self.x = x if isinstance(x, np.ndarray) else np.array(x)
        if self.x.ndim == 1:
            self.x = self.x.reshape([self.x.size, 1])
        self.y = y if isinstance(y, np.ndarray) else np.array(y)
        self.y_err = (
            y_err if isinstance(y_err, (np.ndarray, type(None))) else np.array(y_err)
        )

        self.bounds = bounds
        self.kernel = kernel
        self.mean = mean
        self.cross_val = cross_val
        self.n_processes = n_processes
        self.optimizer = optimizer

        # bucket padding: the optimisation loop refits on a growing dataset
        # every iteration; padding to a bucket keeps the compiled-program
        # shapes stable so refits reuse compilations
        self.pad_to = 64
        self.gp = GpRegressor(
            x=self.x,
            y=self.y,
            y_err=self.y_err,
            hyperpars=hyperpars,
            kernel=kernel,
            mean=mean,
            cross_val=cross_val,
            optimizer=self.optimizer,
            n_processes=self.n_processes,
            pad_to=self.pad_to,
        )

        self.acquisition = acquisition() if isclass(acquisition) else acquisition
        self.acquisition.update_gp(self.gp)
        self.mu_max = self.y.max()

        self._acq_max_history = []
        self._conv_metric_history = []
        self._iter_history = []
        self._pending = None  # deferred-refit record (device optimizer)

    # The histories are reference-parity public attributes users poll in
    # stopping criteria (reference: inference/gp/optimisation.py:129-131);
    # with the deferred device refit they are filled one dispatch later,
    # so plain reads flush the pending record first — a user loop never
    # sees a list one entry short.
    @property
    def acquisition_max_history(self):
        self._ensure_current()
        return self._acq_max_history

    @property
    def convergence_metric_history(self):
        self._ensure_current()
        return self._conv_metric_history

    @property
    def iteration_history(self):
        self._ensure_current()
        return self._iter_history

    def __call__(self, x):
        self._ensure_current()
        return self.gp(x)

    def add_evaluation(self, new_x, new_y, new_y_err=None):
        """
        Add the latest evaluation to the data set and re-train the
        Gaussian process (a full refit, including hyperparameters).

        With ``optimizer="device"`` the refit is DEFERRED and fused into
        the next ``propose_evaluation`` as a single device dispatch (refit
        multistart + Cholesky/alpha state + acquisition multistart) — each
        separate dispatch costs a device round trip, and the eager path
        spends 4-5 of them per iteration. Note
        that ``self.gp`` is stale between the two calls; the public
        surfaces (``__call__``, ``plot_results``, the history
        attributes, the next ``add_evaluation``) flush the pending refit
        automatically — call any of them (or ``propose_evaluation``)
        before touching ``self.gp`` directly.
        """
        new_x = new_x if isinstance(new_x, np.ndarray) else np.array(new_x)
        if new_x.shape != (1, self.x.shape[1]):
            new_x = new_x.reshape((1, self.x.shape[1]))
        new_y = new_y if isinstance(new_y, np.ndarray) else np.array(new_y)
        good_type = isinstance(new_y_err, (np.ndarray, type(None)))
        new_y_err = new_y_err if good_type else np.array(new_y_err)

        deferred = self.optimizer == "device"
        if deferred and getattr(self, "_pending", None) is not None:
            # two adds without an intervening proposal: settle the first
            self._ensure_current()

        if not deferred:
            # one acquisition evaluation serves both history entries
            acq_value = self.acquisition(new_x.squeeze())
            self._acq_max_history.append(acq_value)
            self._conv_metric_history.append(
                self.acquisition.convergence_from_acquisition(acq_value)
            )
            self._iter_history.append(self.y.size + 1)
        else:
            # the acquisition value at new_x (under the state that
            # proposed it) is computed inside the next fused dispatch;
            # keep the scalars its history entries need
            self._pending = {
                "new_x": np.asarray(new_x, dtype=float).ravel(),
                "old_state": self.acquisition.gp_state(),
                "mu_max": float(self.mu_max),
                "y_min": float(self.y.min()),
            }

        self.x = np.append(self.x, new_x, axis=0)
        self.y = np.append(self.y, new_y)

        if self.y_err is not None:
            if new_y_err is not None:
                self.y_err = np.append(self.y_err, new_y_err)
            else:
                raise ValueError(
                    "[ GpOptimiser error ] 'new_y_err' argument of the "
                    "'add_evaluation' method must be specified if the 'y_err' "
                    "argument was specified when the instance of GpOptimiser "
                    "was initialised."
                )

        # in-place data update: every compiled GP / acquisition program
        # takes the data as runtime arguments, so the refit reuses all
        # compilations while the padded shape (pad_to bucket) is unchanged
        self.gp.update_data(
            self.x, self.y, y_err=self.y_err, set_state=not deferred
        )
        if not deferred:
            self.gp.set_hyperparameters(
                self.gp.fit(
                    optimizer=self.optimizer, n_processes=self.n_processes
                )
            )
            self.mu_max = self.y.max()
            self.acquisition.update_gp(self.gp)

    def _ensure_current(self):
        """Settle a deferred refit (non-fused fallback: history entry +
        fit + state, for callers that need the GP before the next
        proposal)."""
        pending = getattr(self, "_pending", None)
        if pending is None:
            return
        import jax.numpy as jnp

        obj_old = float(
            self.acquisition._opt_func_jit(
                jnp.asarray(pending["new_x"], self.gp._x_dev.dtype),
                pending["old_state"],
            )
        )
        if not pending.get("history_done"):
            self._append_history(pending, obj_old)
            pending["history_done"] = True
        self.gp.set_hyperparameters(
            self.gp.fit(optimizer=self.optimizer, n_processes=self.n_processes)
        )
        self.mu_max = self.y.max()
        self.acquisition.update_gp(self.gp)
        # cleared only after the refit succeeded (see _fused_propose)
        self._pending = None

    def _append_history(self, pending, obj_old: float):
        acq_value = self.acquisition._value_from_objective(obj_old)
        self._acq_max_history.append(acq_value)
        self._conv_metric_history.append(
            self.acquisition.convergence_from_acquisition(
                acq_value, mu_max=pending["mu_max"], y_min=pending["y_min"]
            )
        )
        self._iter_history.append(self.y.size)

    def diff_evo(self):
        opt_result = differential_evolution(
            self.acquisition.opt_func, self.bounds, popsize=30
        )
        solution = opt_result.x
        funcval = opt_result.fun
        if hasattr(funcval, "__len__"):
            funcval = funcval[0]
        return solution, funcval

    def launch_bfgs(self, x0):
        return fmin_l_bfgs_b(
            self.acquisition.opt_func_gradient,
            x0,
            approx_grad=False,
            bounds=self.bounds,
            pgtol=1e-10,
        )

    def multistart_bfgs(self):
        starting_positions = self.acquisition.starting_positions(self.bounds)
        results = [self.launch_bfgs(x0) for x0 in starting_positions]
        best_result = sorted(results, key=lambda x: float(x[1]))[0]
        return best_result[0], float(best_result[1])

    def multistart_device(self):
        """
        Maximise the acquisition with every start running in parallel on
        device: a vmapped BFGS over sigmoid-bounded coordinates (one
        dispatch for all starts), followed by a second, tighter on-device
        BFGS refinement of the winner — no host optimiser loop at all.
        Replaces the host loop of ``multistart_bfgs``, which pays a device
        round-trip per objective evaluation per start.
        """
        import jax
        import jax.numpy as jnp
        from jax.scipy.optimize import minimize as jax_minimize

        lwr = np.array([b[0] for b in self.bounds], dtype=float)
        upr = np.array([b[1] for b in self.bounds], dtype=float)
        span = upr - lwr

        starts = np.asarray(self.acquisition.starting_positions(self.bounds))
        # map starts into unconstrained sigmoid coordinates, keeping them
        # off the boundary where the reparameterisation gradient vanishes
        frac = np.clip((starts - lwr) / span, 0.01, 0.99)
        z0 = np.log(frac / (1.0 - frac))
        # pad the start count to a bucket so the compiled program shape is
        # reused as the data set grows between iterations
        bucket = 16
        n_pad = -len(z0) % bucket
        if n_pad:
            z0 = np.concatenate([z0, np.repeat(z0[:1], n_pad, axis=0)])

        solver = getattr(self, "_ms_solver", None)
        if solver is None:
            objective = self.acquisition._objective

            def neg(z, lo, sp, st):
                return objective(lo + sp * jax.nn.sigmoid(z), st)

            def solve_one(z, lo, sp, st):
                res = jax_minimize(
                    neg, z, args=(lo, sp, st), method="BFGS",
                    options={"maxiter": 150},
                )
                return res.x, res.fun

            def solve_and_refine(z0, lo, sp, st):
                """All starts + winner refinement in ONE device program."""
                zs, fs = jax.vmap(
                    solve_one, in_axes=(0, None, None, None)
                )(z0, lo, sp, st)
                best = jnp.nanargmin(jnp.where(jnp.isfinite(fs), fs, jnp.inf))
                res = jax_minimize(
                    neg, zs[best], args=(lo, sp, st), method="BFGS",
                    options={"maxiter": 400, "gtol": 1e-10},
                )
                better = res.fun <= fs[best]
                return (
                    jnp.where(better, res.x, zs[best]),
                    jnp.where(better, res.fun, fs[best]),
                )

            solver = jax.jit(solve_and_refine)
            self._ms_solver = solver

        z_best, fun_val = solver(
            jnp.asarray(z0), jnp.asarray(lwr), jnp.asarray(span),
            self.acquisition.gp_state(),
        )
        x_best = lwr + span / (1.0 + np.exp(-np.asarray(z_best)))
        return np.clip(x_best, lwr, upr), float(fun_val)

    # ------------------------------------------------------------------ #
    # fused single-dispatch iteration (device optimizer)
    # ------------------------------------------------------------------ #
    def _candidate_clouds(self, bucket: int = 16):
        """Host-side acquisition multistart seeds, one cloud per data
        point (reference: acquisition.py:13-37 evaluates these one at a
        time; here the cloud scoring happens inside the fused program,
        under the freshly refit GP). The cloud policy lives in
        ``acquisition.candidate_cloud`` — shared with the host multistart
        path. Padded to a ``bucket`` multiple of clouds so the compiled
        shape is stable as the data set grows; out-of-bounds points and
        padding rows contribute uniform draws instead (harmless extra
        starts)."""
        from .acquisition import CLOUD_INSET, CLOUD_SIZE, candidate_cloud

        lwr = np.array([b[0] for b in self.bounds], dtype=float)
        upr = np.array([b[1] for b in self.bounds], dtype=float)
        widths = upr - lwr
        lwr_in = lwr + widths * CLOUD_INSET
        upr_in = upr - widths * CLOUD_INSET
        L = lwr.size
        rng = np.random.default_rng()

        n = self.x.shape[0]
        S = -(-n // bucket) * bucket
        cand = np.empty((S, CLOUD_SIZE, L))
        for idx in range(S):
            x0 = self.x[idx] if idx < n else None
            cand[idx] = candidate_cloud(x0, lwr_in, upr_in, widths, rng)
        return cand

    def _build_fused_step(self):
        """One compiled program for a full warm BO iteration: acquisition
        value of the just-evaluated point (old state), hyperparameter
        multistart refit, Cholesky/alpha state, candidate-cloud scoring
        and the acquisition multistart — a single device dispatch where
        the eager path pays 4-5 network round trips per iteration."""
        import jax
        import jax.numpy as jnp
        from jax.scipy.optimize import minimize as jax_minimize

        gp = self.gp
        _, _, fit_refine_raw = gp._fit_multistart_parts(16)
        fit_state_raw = gp._fit_state_raw
        objective = self.acquisition._objective
        cov_slc, mean_slc = gp.cov_slice, gp.mean_slice

        def neg_acq(z, lo, sp, st):
            return objective(lo + sp * jax.nn.sigmoid(z), st)

        def acq_solve_one(z, lo, sp, st):
            res = jax_minimize(
                neg_acq, z, args=(lo, sp, st), method="BFGS",
                options={"maxiter": 150},
            )
            z_ok = jnp.isfinite(res.x).all()
            return (
                jnp.where(z_ok, res.x, z),
                jnp.where(z_ok & jnp.isfinite(res.fun), res.fun, jnp.inf),
            )

        def fused(
            z0_fit, lo_f, hi_f, x, y, sig, m,
            cand, lo_a, span_a, new_x, old_state,
        ):
            obj_old = objective(new_x, old_state)

            _, _, z_best = fit_refine_raw(z0_fit, lo_f, hi_f, x, y, sig, m)
            theta = lo_f + (hi_f - lo_f) * jax.nn.sigmoid(z_best)
            K_xx, mu, L, alpha = fit_state_raw(theta, x, y, sig, m)
            mu_max = jnp.max(jnp.where(m > 0, y, -jnp.inf))
            st = (x, L, alpha, theta[cov_slc], theta[mean_slc], m, mu_max)

            scores = jax.vmap(
                jax.vmap(objective, in_axes=(0, None)), in_axes=(0, None)
            )(cand, st)
            winners = cand[jnp.arange(cand.shape[0]), jnp.argmin(scores, axis=1)]
            frac = jnp.clip((winners - lo_a) / span_a, 0.01, 0.99)
            z0 = jnp.log(frac / (1.0 - frac))
            zs, fs = jax.vmap(
                acq_solve_one, in_axes=(0, None, None, None)
            )(z0, lo_a, span_a, st)
            best = jnp.argmin(fs)
            z_start = jnp.where(
                jnp.isfinite(fs[best]), zs[best], jnp.zeros_like(zs[best])
            )
            res = jax_minimize(
                neg_acq, z_start, args=(lo_a, span_a, st), method="BFGS",
                options={"maxiter": 400, "gtol": 1e-10},
            )
            improved = (res.fun <= fs[best]) & jnp.isfinite(res.x).all()
            z_prop = jnp.where(improved, res.x, z_start)
            f_prop = jnp.where(improved, res.fun, fs[best])
            return theta, K_xx, mu, L, alpha, obj_old, z_prop, f_prop

        return jax.jit(fused)

    def _fused_propose(self):
        import jax
        import jax.numpy as jnp

        pending = self._pending
        gp = self.gp

        fused = getattr(self, "_fused_step", None)
        if fused is None:
            fused = self._fused_step = self._build_fused_step()

        z0_fit = getattr(self, "_z0_fit", None)
        if z0_fit is None:
            # same deterministic start set as GpRegressor.fit_device
            rng = np.random.default_rng(0)
            u = rng.uniform(0.05, 0.95, size=(15, gp.n_hyperpars))
            z0_fit = self._z0_fit = np.concatenate(
                [np.log(u / (1 - u)), np.zeros((1, gp.n_hyperpars))]
            )

        lo_f = np.array([b[0] for b in gp.hp_bounds], dtype=float)
        hi_f = np.array([b[1] for b in gp.hp_bounds], dtype=float)
        lwr = np.array([b[0] for b in self.bounds], dtype=float)
        upr = np.array([b[1] for b in self.bounds], dtype=float)
        span = upr - lwr

        # operands cast to the GP working dtype: uncast float64 inputs
        # under jax_enable_x64 would promote the whole fused program
        # (Cholesky included) to float64
        wd = gp._x_dev.dtype
        out = fused(
            jnp.asarray(z0_fit, wd), jnp.asarray(lo_f, wd),
            jnp.asarray(hi_f, wd),
            gp._x_dev, gp._y_dev, gp._sig_dev, gp._mask_dev,
            jnp.asarray(self._candidate_clouds(), wd),
            jnp.asarray(lwr, wd), jnp.asarray(span, wd),
            jnp.asarray(pending["new_x"], wd), pending["old_state"],
        )
        theta_dev, K_xx, mu, L, alpha, obj_old, z_prop, f_prop = out
        # one consolidated device->host transfer of the small results;
        # the big state arrays (K_xx, L, alpha) stay on device
        theta_np, obj_old_np, z_np, f_np = jax.device_get(
            (theta_dev, obj_old, z_prop, f_prop)
        )

        gp.hyperpars = np.asarray(theta_np, dtype=float)
        gp.mean_hyperpars = gp.hyperpars[gp.mean_slice]
        gp.cov_hyperpars = gp.hyperpars[gp.cov_slice]
        gp.K_xx, gp.mu, gp.L, gp.alpha = K_xx, mu, L, alpha
        gp._cov_pars_dev = theta_dev[gp.cov_slice]
        gp._mean_pars_dev = theta_dev[gp.mean_slice]
        gp._state_stale = False  # the fused program just rebuilt L/alpha

        if not pending.get("history_done"):
            self._append_history(pending, float(obj_old_np))
            pending["history_done"] = True
        self.mu_max = float(self.y.max())
        self.acquisition.update_gp(gp)
        # only now is the deferred refit settled: clearing _pending before
        # this point would mark stale GP state current if the fused
        # program raised mid-way
        self._pending = None

        x_best = lwr + span / (1.0 + np.exp(-np.asarray(z_np)))
        return np.clip(x_best, lwr, upr), float(f_np)

    def propose_evaluation(self, optimizer=None):
        """
        Propose the next evaluation location by maximising the acquisition
        function.
        """
        opt = optimizer if optimizer is not None else self.optimizer
        pending = getattr(self, "_pending", None)
        if opt == "device" and pending is not None:
            proposed_ev, _ = self._fused_propose()
        else:
            self._ensure_current()
            if opt == "bfgs":
                proposed_ev, _ = self.multistart_bfgs()
            elif opt == "device":
                proposed_ev, _ = self.multistart_device()
            else:
                proposed_ev, _ = self.diff_evo()
        if hasattr(proposed_ev, "__len__") and len(proposed_ev) == 1:
            proposed_ev = proposed_ev[0]
        return proposed_ev

    def plot_results(self, filename: str = None, show_plot=True):
        """Two-panel BO summary: running best + raw evaluations on the
        left, the acquisition convergence metric (log scale) on the
        right (output parity with reference: optimisation.py:251-292)."""
        self._ensure_current()
        from ..utils.figures import finish_figure, series_with_markers_panel

        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(10, 4))
        maxvals = np.maximum.accumulate(self.y)
        pad = np.ptp(maxvals) * 0.1 if np.ptp(maxvals) > 0 else 1.0
        series_with_markers_panel(
            fig.add_subplot(121),
            np.arange(len(self.y)) + 1,
            line=(maxvals, dict(c="red", alpha=0.6, label="max observed value")),
            markers=(self.y, dict(label="function evaluations", markersize=10)),
            ylabel="function value",
            ylim=[maxvals.min() - pad, maxvals.max() + pad],
            legend_kwargs=dict(loc=4),
        )
        series_with_markers_panel(
            fig.add_subplot(122),
            self.iteration_history,
            line=(self.convergence_metric_history, dict(c="C0", alpha=0.35)),
            markers=(
                self.convergence_metric_history,
                dict(
                    c="C0",
                    label=self.acquisition.convergence_description,
                    markersize=10,
                ),
            ),
            ylabel="acquisition function value",
            title="Convergence summary",
            yscale="log",
            xlim=[0, None],
        )
        finish_figure(fig, plt, show_plot, filename)
