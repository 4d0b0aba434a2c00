"""Acquisition functions for Gaussian-process optimisation.

JAX rebuild of the reference acquisition classes
(reference: inference/gp/acquisition.py:8-232). The expected-improvement
implementation uses a single numerically-stable log-domain formula built on
``log_ndtr`` (replacing the reference's explicit ``erfcx`` branch for
Z < -3, reference: acquisition.py:76-97); spatial gradients come from
autodiff of the jitted acquisition instead of hand-derived expressions.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import log_ndtr

# multistart seeding policy (reference: acquisition.py:13-37), shared by
# the host path (AcquisitionFunction.starting_positions) and the fused
# device path (GpOptimiser._candidate_clouds) — tune it here, once
CLOUD_SIZE = 20  # candidates per observed data point
CLOUD_INSET = 0.01  # bounds inset, as a fraction of the box width
CLOUD_WIDTH = 0.02  # cloud half-width, as a fraction of the box width


def candidate_cloud(x0, lwr_in, upr_in, widths, rng) -> np.ndarray:
    """A ``CLOUD_SIZE``-point multistart cloud around an observed point
    lying inside the inset bounds, or uniform draws over the inset box
    when it does not (``x0`` may be None for pure padding rows)."""
    L = widths.size
    if x0 is not None and ((x0 >= lwr_in) & (x0 <= upr_in)).all():
        return np.clip(
            x0[None, :]
            + CLOUD_WIDTH * widths * (2 * rng.random((CLOUD_SIZE, L)) - 1),
            lwr_in,
            upr_in,
        )
    return lwr_in + (upr_in - lwr_in) * rng.random((CLOUD_SIZE, L))


class AcquisitionFunction:
    gp = None
    mu_max: float

    def starting_positions(self, bounds):
        """
        Multistart seeds: a small random search around each observed data
        point inside the bounds, plus uniform draws for points outside
        (reference: acquisition.py:13-37). All candidates are scored in ONE
        batched device call (the reference evaluates them one at a time;
        on an accelerator each evaluation would be a device round-trip).
        """
        lwr, upr = [np.array([k[i] for k in bounds], dtype=float) for i in [0, 1]]
        widths = upr - lwr
        lwr = lwr + widths * CLOUD_INSET
        upr = upr - widths * CLOUD_INSET
        rng = np.random.default_rng()
        L = len(widths)

        starts = []
        groups = []  # (index into starts, cloud rows) for inside points
        candidates = []
        for x0 in self.gp.x:
            inside = ((x0 >= lwr) & (x0 <= upr)).all()
            if inside:
                groups.append((len(starts), len(candidates)))
                candidates.append(candidate_cloud(x0, lwr, upr, widths, rng))
                starts.append(None)  # filled in after batch scoring
            else:
                starts.append(lwr + (upr - lwr) * rng.random(L))

        if candidates:
            cand = np.concatenate(candidates, axis=0)  # (CLOUD_SIZE * n_inside, L)
            scores = np.asarray(
                self._opt_batch_jit(jnp.asarray(cand), self.gp_state())
            )
            # per-group winner: candidates were appended in cloud-row blocks
            c = CLOUD_SIZE
            for g, (start_idx, _) in enumerate(groups):
                block = scores[g * c : (g + 1) * c]
                starts[start_idx] = cand[g * c + int(np.argmin(block))]
        return starts

    def update_gp(self, gp):
        """Point the acquisition at (fresh or refit) GP state. The compiled
        programs take the whole GP state as runtime arguments, so a refit of
        the same padded shape reuses every compilation; the jits are rebuilt
        only when a different ``GpRegressor`` object is supplied."""
        rebuild = getattr(self, "_compiled_gp_id", None) != id(gp)
        self.gp = gp
        self.mu_max = gp.y.max()
        if rebuild:
            self._build_compiled()
            self._compiled_gp_id = id(gp)

    def gp_state(self):
        """The runtime-argument pytree for the compiled acquisition
        programs: fitted GP state plus the current best observed value."""
        gp = self.gp
        return (
            gp._x_dev,
            gp.L,
            gp.alpha,
            gp._cov_pars_dev,
            gp._mean_pars_dev,
            gp._mask_dev,
            jnp.asarray(self.mu_max, gp.L.dtype),
        )

    def _mu_var(self, q, st):
        """Traceable predictive mean and variance at a single point."""
        x, L, alpha, cov_pars, mean_pars, m, _ = st
        return self.gp._predict_single(q, x, L, alpha, cov_pars, mean_pars, m)

    def _build_compiled(self):
        objective = self._objective
        self._opt_func_jit = jax.jit(objective)
        self._opt_func_grad_jit = jax.jit(jax.value_and_grad(objective, argnums=0))
        self._opt_batch_jit = jax.jit(jax.vmap(objective, in_axes=(0, None)))

    def _objective(self, q, st):
        raise NotImplementedError

    def _value_from_objective(self, v: float) -> float:
        """Map a raw ``_objective`` value back to the acquisition value
        (the quantity ``__call__`` returns) without a device evaluation."""
        return -v

    def opt_func(self, x) -> float:
        q = jnp.asarray(np.asarray(x, dtype=float).flatten())
        return float(self._opt_func_jit(q, self.gp_state()))

    def opt_func_gradient(self, x):
        q = jnp.asarray(np.asarray(x, dtype=float).flatten())
        value, grad = self._opt_func_grad_jit(q, self.gp_state())
        return np.asarray(value, dtype=float), np.asarray(grad, dtype=float).squeeze()


class ExpectedImprovement(AcquisitionFunction):
    r"""
    Expected improvement
    ``EI(x) = (z F(z) + P(z)) sigma(x)`` with
    ``z = (mu(x) - y_max) / sigma(x)``, computed in the log domain for
    numerical stability at strongly negative ``z``.
    """

    def __init__(self):
        self.name = "Expected improvement"
        self.convergence_description = (
            r"$\mathrm{EI}_{\mathrm{max}} \; / \; (y_{\mathrm{max}} - "
            r"y_{\mathrm{min}})$"
        )

    def _log_ei(self, q, st):
        mu, var = self._mu_var(q, st)
        sig = jnp.sqrt(jnp.abs(var))
        z = (mu - st[-1]) / sig
        # EI = sig * (z Phi(z) + phi(z)), branched for stability at both
        # tails: for z >= 0 the direct form never overflows (Phi <= 1,
        # phi <= 0.4); for z < 0 the log-domain form
        # log phi + log(1 + z Phi/phi) avoids underflow. The previous
        # single formula exp(log_ndtr - log_phi) ~ e^{z^2/2} overflowed
        # float32 for z > ~13 — exactly the highest-EI points.
        pos = z >= 0
        z_pos = jnp.maximum(z, 0.0)
        z_neg = jnp.minimum(z, 0.0)
        log_phi_pos = -0.5 * (z_pos**2 + jnp.log(2 * jnp.pi))
        direct = z_pos * jnp.exp(log_ndtr(z_pos)) + jnp.exp(log_phi_pos)
        log_ei_pos = jnp.log(jnp.maximum(direct, 1e-300))

        log_phi_neg = -0.5 * (z_neg**2 + jnp.log(2 * jnp.pi))
        ratio = jnp.exp(log_ndtr(z_neg) - log_phi_neg)  # <= ~0.8 for z <= 0
        h = jnp.maximum(1.0 + z_neg * ratio, 1e-300)
        log_ei_neg = log_phi_neg + jnp.log(h)

        return jnp.log(sig) + jnp.where(pos, log_ei_pos, log_ei_neg)

    def _objective(self, q, st):
        return -self._log_ei(q, st)

    def _value_from_objective(self, v: float) -> float:
        return float(np.exp(-v))

    def __call__(self, x) -> float:
        # one dispatch through the compiled objective (-log EI)
        return float(np.exp(-self.opt_func(x)))

    def convergence_metric(self, x) -> float:
        return self.convergence_from_acquisition(self.__call__(x))

    def convergence_from_acquisition(
        self, value: float, mu_max=None, y_min=None
    ) -> float:
        """Convergence metric derived from an already-computed acquisition
        value (no extra device evaluation). ``mu_max``/``y_min`` override
        the live attributes — for deferred history entries that must use
        the values current when the point was evaluated."""
        mu_max = self.mu_max if mu_max is None else mu_max
        y_min = float(self.gp.y.min()) if y_min is None else y_min
        return value / (mu_max - y_min)


class UpperConfidenceBound(AcquisitionFunction):
    r"""
    Upper confidence bound ``UCB(x) = mu(x) + kappa * sigma(x)``
    (reference: acquisition.py:143-192).
    """

    def __init__(self, kappa: float = 2.0):
        self.kappa = kappa
        self.name = "Upper confidence bound"
        self.convergence_description = (
            r"$\mathrm{UCB}_{\mathrm{max}} - y_{\mathrm{max}}$"
        )

    def _objective(self, q, st):
        mu, var = self._mu_var(q, st)
        return -(mu + self.kappa * jnp.sqrt(jnp.abs(var)))

    def __call__(self, x) -> float:
        return -self.opt_func(x)

    def convergence_metric(self, x) -> float:
        return self.convergence_from_acquisition(self.__call__(x))

    def convergence_from_acquisition(
        self, value: float, mu_max=None, y_min=None
    ) -> float:
        return value - (self.mu_max if mu_max is None else mu_max)


class MaxVariance(AcquisitionFunction):
    r"""
    Pure-exploration acquisition: maximises the predictive variance
    (reference: acquisition.py:195-232).
    """

    def __init__(self):
        self.name = "Max variance"
        self.convergence_description = r"$\sqrt{\mathrm{Var}\left[x\right]}$"

    def _objective(self, q, st):
        _, var = self._mu_var(q, st)
        return -var

    def __call__(self, x) -> float:
        return -self.opt_func(x)

    def convergence_metric(self, x) -> float:
        return self.convergence_from_acquisition(self.__call__(x))

    def convergence_from_acquisition(
        self, value: float, mu_max=None, y_min=None
    ) -> float:
        return float(np.sqrt(value))
