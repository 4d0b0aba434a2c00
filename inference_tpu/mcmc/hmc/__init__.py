"""Hamiltonian Monte-Carlo sampler.

JAX rebuild of the reference ``HamiltonianChain``
(reference: inference/mcmc/hmc/__init__.py:14-469). The user-facing API is
preserved; the sampling loop compiles to a single ``lax.scan`` on device
(see ``inference_tpu.mcmc._kernels.hmc``), with gradients supplied by
``jax.grad`` of the user posterior — the reference's user-``grad`` argument
and finite-difference fallback (reference: hmc/__init__.py:81,211-218) both
collapse into autodiff when the posterior is jax-traceable.
"""

import numpy as np
import jax
import jax.numpy as jnp

from ...utils import (
    Bounds,
    ChainProgressPrinter,
    effective_sample_size,
    make_key,
    default_float,
    as_device_logp,
    is_traceable,
)
from ..base import MarkovChain
from .._kernels.hmc import make_hmc_step, init_hmc_state, run_steps, HmcState
from .._kernels.common import AdaptiveScale
from .epsilon import EpsilonSelector
from .mass import get_particle_mass, ParticleMass, ScalarMass, VectorMass, MatrixMass

__all__ = [
    "HamiltonianChain",
    "EpsilonSelector",
    "ParticleMass",
    "ScalarMass",
    "VectorMass",
    "MatrixMass",
    "get_particle_mass",
]


class HamiltonianChain(MarkovChain):
    """
    Hamiltonian Monte-Carlo sampling with automatic step-size adaptation.

    :param posterior: \
        A callable which takes the vector of model parameters and returns the
        posterior log-probability. jax-traceable posteriors run compiled on
        device; plain numpy posteriors are automatically wrapped in a host
        callback (slower, and requiring an explicit ``grad``).

    :param start: \
        Parameter vector at which the chain starts.

    :param grad: \
        A callable returning the gradient of the log-posterior. If omitted,
        the gradient is computed by jax autodiff of ``posterior`` (or by
        finite differences if the posterior is not traceable).

    :param epsilon: \
        Initial guess for the leapfrog time-step.

    :param temperature: \
        Chain temperature (used by parallel tempering).

    :param bounds: \
        An ``inference_tpu.Bounds`` instance or ``(lower, upper)`` arrays; a
        reflecting leapfrog integrator is used when given.

    :param inverse_mass: \
        Scalar, vector (diagonal) or matrix inverse-mass.

    :param display_progress: \
        Whether to print progress/ETA messages during sampling.

    :param seed: \
        Optional integer PRNG seed (fresh OS entropy when omitted).
    """

    def __init__(
        self,
        posterior: callable,
        start,
        grad: callable = None,
        epsilon: float = 0.1,
        temperature: float = 1.0,
        bounds=None,
        inverse_mass=None,
        display_progress=True,
        seed=None,
    ):
        self.posterior = posterior
        self.user_grad = grad
        self.temperature = temperature
        self.inv_temp = 1.0 / temperature
        self.steps = 50
        self.max_attempts = 200
        self.ES = EpsilonSelector(epsilon)
        self._key = make_key(seed)
        self._state = None
        self._step = None
        self._step_config = None
        self.chain_length = 1
        self._pending_eps = []
        self._device_history_bytes = 0

        # set up bounds
        if bounds is None:
            self.bounds = None
        elif isinstance(bounds, Bounds):
            self.bounds = bounds
        else:
            self.bounds = Bounds(
                lower=bounds[0], upper=bounds[1], error_source="HamiltonianChain"
            )

        if start is not None:
            start = np.asarray(start, dtype=float)
            assert start.ndim == 1
            self._validate_posterior(posterior=posterior, start=start)
            self.n_parameters = start.size
            self.mass = get_particle_mass(
                inverse_mass=inverse_mass if inverse_mass is not None else 1.0,
                n_parameters=self.n_parameters,
            )
            if self.bounds is not None:
                self.bounds.validate_start_point(
                    start, error_source="HamiltonianChain"
                )

            dtype = default_float()
            self._logp = as_device_logp(posterior, start)
            p0 = float(self._logp(jnp.asarray(start, dtype))) * self.inv_temp
            self._state = init_hmc_state(
                jnp.asarray(start, dtype), p0, epsilon, self._key,
                inv_temp=self.inv_temp, steps=self.steps,
            )
            # host-side history (numpy chunks, concatenated lazily)
            self._theta_chunks = [start.reshape(1, -1)]
            self._prob_chunks = [np.array([p0])]
            self._leapfrog_chunks = [np.array([0], dtype=int)]
        else:
            self._logp = None

        self.display_progress = display_progress
        self.ProgressPrinter = ChainProgressPrinter(
            display=self.display_progress, leading_msg="advancing chain:"
        )

    # ------------------------------------------------------------------ #
    # device execution
    # ------------------------------------------------------------------ #
    def _gradient_fn(self, start):
        """Resolve the gradient function: user-supplied, autodiff, or FD."""
        if self.user_grad is not None:
            grad = self.user_grad
            if is_traceable(lambda t: jnp.asarray(grad(t)).sum(), start):
                return lambda t: jnp.asarray(grad(t), t.dtype).reshape(t.shape)
            result_shape = jax.ShapeDtypeStruct(
                (self.n_parameters,), default_float()
            )

            def host_grad(theta):
                return np.asarray(grad(np.asarray(theta)), dtype=theta.dtype)

            return lambda t: jax.pure_callback(
                host_grad, result_shape, t, vmap_method="sequential"
            )

        if is_traceable(self.posterior, start):
            return jax.grad(self._logp)

        # finite-difference fallback for host-callback posteriors
        logp = self._logp

        def fd_grad(t):
            h = 1e-6 * jnp.maximum(jnp.abs(t), 1.0)
            p0 = logp(t)

            def one(i):
                return (logp(t.at[i].add(h[i])) - p0) / h[i]

            return jax.lax.map(one, jnp.arange(t.size))

        return fd_grad

    def _get_step(self):
        # 'steps' is deliberately absent: it lives in the state as a traced
        # value, so changing it does not rebuild (recompile) the kernel
        config = (
            self.max_attempts,
            id(self.mass),
            id(self.bounds),
        )
        if self._step is None or self._step_config != config:
            start = np.asarray(self._theta_chunks[0][0])
            grad_fn = self._gradient_fn(start)
            reflect = None if self.bounds is None else self.bounds.reflect_momenta
            self._step = make_hmc_step(
                self._logp,
                grad_fn,
                max_attempts=self.max_attempts,
                mass_velocity=self.mass.get_velocity,
                mass_sample=self.mass.sample_momentum,
                bounds_reflect=reflect,
            )
            self._step_config = config
        return self._step

    def _run_chunk(self, n: int):
        if self.posterior is None or self._logp is None:
            raise ValueError(
                "[ HamiltonianChain error ] Cannot advance a chain loaded without "
                "a 'posterior' callable."
            )
        step = self._get_step()
        # sync the (possibly user-modified) steps attribute into the traced
        # state — a tiny async host->device transfer, never a recompile
        self._state = self._state._replace(
            steps=jnp.asarray(self.steps, jnp.int32)
        )
        state, outs = run_steps(step, self._state, n)
        failed = bool(state.failed)
        if failed:
            raise ValueError(
                f"[ HamiltonianChain error ] Failed to take step within maximum "
                f"allowed attempts of {self.max_attempts}"
            )
        self._state = state
        self._absorb_outputs(outs)
        eps = self._state.eps
        self.ES.sync_counters(eps.avg, eps.var, eps.num, eps.chk_int)

    def _absorb_outputs(self, outs):
        """Append a chunk of outputs to the history. Chunks stay on the
        device until a host view is requested or the device-history budget
        is exceeded (consolidated transfers either way)."""
        from ...utils.history import DEVICE_HISTORY_LIMIT

        start_step = self.chain_length
        self._theta_chunks.append(outs.theta)
        self._prob_chunks.append(outs.logp)
        self._leapfrog_chunks.append(outs.leapfrog_steps)
        self.chain_length += int(outs.logp.shape[0])
        self._pending_eps.append((outs.epsilon, start_step))
        if not isinstance(outs.logp, np.ndarray):
            self._device_history_bytes += outs.theta.nbytes + outs.logp.nbytes
        if self._device_history_bytes > DEVICE_HISTORY_LIMIT:
            self._consolidated_theta()
            self._consolidated_probs()
            self._drain_epsilon_trace()

    def _fetch_history(self):
        """Move any device-held history chunks to the host (one transfer)."""
        if self._device_history_bytes > 0:
            fetched = jax.device_get(
                (self._theta_chunks, self._prob_chunks, self._leapfrog_chunks)
            )
            self._theta_chunks = [np.asarray(c) for c in fetched[0]]
            self._prob_chunks = [np.asarray(c) for c in fetched[1]]
            self._leapfrog_chunks = [np.asarray(c) for c in fetched[2]]
            self._device_history_bytes = 0

    def _drain_epsilon_trace(self):
        """Process deferred per-step epsilon traces into the host-side
        ``EpsilonSelector`` change-point log."""
        if not self._pending_eps:
            return
        pending, self._pending_eps = self._pending_eps, []
        for eps, start_step in jax.device_get(pending):
            self.ES.record_trace(np.asarray(eps), int(start_step))

    # ------------------------------------------------------------------ #
    # host history views
    # ------------------------------------------------------------------ #
    @property
    def theta(self):
        """Chain positions as a list of parameter vectors."""
        return [v for v in self._consolidated_theta()]

    @property
    def probs(self):
        """Tempered log-probabilities for each chain step."""
        return list(self._consolidated_probs())

    @property
    def leapfrog_steps(self):
        self._fetch_history()
        return list(np.concatenate(self._leapfrog_chunks))

    def _consolidated_theta(self) -> np.ndarray:
        self._fetch_history()
        if len(self._theta_chunks) > 1:
            self._theta_chunks = [np.concatenate(self._theta_chunks, axis=0)]
        return self._theta_chunks[0]

    def _consolidated_probs(self) -> np.ndarray:
        self._fetch_history()
        if len(self._prob_chunks) > 1:
            self._prob_chunks = [np.concatenate(self._prob_chunks)]
        return self._prob_chunks[0]

    def get_last(self) -> np.ndarray:
        return self._consolidated_theta()[-1]

    def replace_last(self, theta):
        theta = np.asarray(theta, dtype=float)
        arr = self._consolidated_theta()
        arr[-1, :] = theta
        self._state = self._state._replace(
            theta=jnp.asarray(theta, self._state.theta.dtype)
        )

    def replace_last_probability(self, logp: float):
        arr = self._consolidated_probs()
        arr[-1] = logp
        self._state = self._state._replace(
            logp=jnp.asarray(logp, self._state.logp.dtype)
        )

    def get_parameter(self, index: int, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return sample values for a chosen parameter with burn/thin slicing."""
        return self._consolidated_theta()[burn::thin, index].squeeze()

    def get_probabilities(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return the log-probability for each step with burn/thin slicing."""
        return self._consolidated_probs()[burn::thin].copy()

    def get_sample(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return the sample as an (n_samples, n_parameters) array."""
        return self._consolidated_theta()[burn::thin].copy()

    def mode(self) -> np.ndarray:
        """Return the sample with the highest posterior probability."""
        probs = self._consolidated_probs()
        return self._consolidated_theta()[probs.argmax()].squeeze()

    # ------------------------------------------------------------------ #
    # adaptation utilities
    # ------------------------------------------------------------------ #
    def estimate_mass(self, burn=1, thin=1, diagonal=True):
        """Re-estimate the inverse mass from the chain variance/covariance."""
        sample = self._consolidated_theta()[burn::thin]
        if diagonal:
            inverse_mass = np.var(sample, axis=0)
        else:
            inverse_mass = np.cov(sample.T)
        self.mass = get_particle_mass(
            inverse_mass=inverse_mass, n_parameters=self.n_parameters
        )

    def estimate_burn_in(self) -> int:
        """
        Estimate burn-in as the later of (a) the first step in the top 1% of
        log-probabilities and (b) the step-size stabilisation point, capped
        at 90% of the chain (reference: hmc/__init__.py:399-408).
        """
        self._drain_epsilon_trace()
        probs = self._consolidated_probs()
        prob_estimate = np.argmax(probs > np.percentile(probs, 99))
        epsl = np.abs(
            (np.array(self.ES.epsilon_values)[::-1] / self.ES.epsilon) - 1.0
        )
        chks = np.array(self.ES.epsilon_checks)[::-1]
        epsl_estimate = chks[np.argmax(epsl > 0.15)]
        return int(min(max(prob_estimate, epsl_estimate), 0.9 * self.chain_length))

    # ------------------------------------------------------------------ #
    # diagnostics
    # ------------------------------------------------------------------ #
    def plot_diagnostics(self, show=True, filename=None, burn=None):
        """
        Plot the log-probability history, the step-size adjustment summary,
        and per-parameter effective sample sizes
        (reference: hmc/__init__.py:245-359).
        """
        from ...utils.figures import (
            ess_panel,
            finish_figure,
            logprob_history_panel,
            summary_text_panel,
        )

        self._drain_epsilon_trace()
        if burn is None:
            burn = self.estimate_burn_in()
        param_ESS = [
            effective_sample_size(np.atleast_1d(self.get_parameter(i, burn=burn)))
            for i in range(self.n_parameters)
        ]
        probs = self._consolidated_probs()

        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(12, 9))
        logprob_history_panel(
            fig.add_subplot(221), probs, burn,
            half_floor_from=self.chain_length // 2,
        )

        # the one HMC-specific panel: leapfrog step-size adaptation
        ax2 = fig.add_subplot(222)
        ax2.plot(
            np.array(self.ES.epsilon_checks) * 1e-3, self.ES.epsilon_values, ".-"
        )
        ax2.set_xlabel("chain step number ($10^3$)", fontsize=12)
        ax2.set_ylabel("Leapfrog step-size", fontsize=12)
        ax2.set_title("Simulation time-step adjustment summary")
        ax2.set_yscale("log")
        ax2.grid()

        ess_panel(fig.add_subplot(223), param_ESS, histogram_above=50)
        summary_text_panel(
            fig.add_subplot(224),
            [
                ("Estimated burn-in:", f"{burn:.5G}"),
                ("Average ESS:", f"{int(np.mean(param_ESS)):.5G}"),
                ("Lowest ESS:", f"{int(np.min(param_ESS)):.5G}"),
            ],
        )
        finish_figure(fig, plt, show, filename)

    # ------------------------------------------------------------------ #
    # checkpointing (.npz key layout matches the reference,
    # reference: hmc/__init__.py:410-469)
    # ------------------------------------------------------------------ #
    def save(self, filename, compressed=False):
        self._drain_epsilon_trace()
        self._fetch_history()
        items = {
            "inv_mass": self.mass.inv_mass,
            "inv_temp": self.inv_temp,
            "theta": self._consolidated_theta(),
            "probs": self._consolidated_probs(),
            "leapfrog_steps": np.concatenate(self._leapfrog_chunks),
            "n_parameters": self.n_parameters,
            "chain_length": self.chain_length,
            "steps": self.steps,
            "display_progress": self.display_progress,
        }
        if self.bounds is not None:
            items["lower_bounds"] = self.bounds.lower
            items["upper_bounds"] = self.bounds.upper
        items.update(self.ES.get_items())

        if compressed:
            np.savez_compressed(filename, **items)
        else:
            np.savez(filename, **items)

    @classmethod
    def load(cls, filename: str, posterior=None, grad=None, seed=None):
        D = np.load(filename)

        if all(k in D for k in ["lower_bounds", "upper_bounds"]):
            bounds = Bounds(
                lower=D["lower_bounds"],
                upper=D["upper_bounds"],
                error_source="HamiltonianChain",
            )
        else:
            bounds = None

        theta = np.asarray(D["theta"], dtype=float)
        chain = cls.__new__(cls)
        chain.posterior = posterior
        chain.user_grad = grad
        chain.inv_temp = float(D["inv_temp"])
        chain.temperature = 1.0 / chain.inv_temp
        chain.steps = int(D["steps"])
        chain.max_attempts = 200
        chain.bounds = bounds
        chain.n_parameters = int(D["n_parameters"])
        chain.chain_length = int(D["chain_length"])
        chain.mass = get_particle_mass(
            inverse_mass=np.asarray(D["inv_mass"]).squeeze()
            if np.asarray(D["inv_mass"]).ndim > 0
            else float(D["inv_mass"]),
            n_parameters=chain.n_parameters,
        )
        chain._theta_chunks = [theta]
        chain._prob_chunks = [np.asarray(D["probs"], dtype=float)]
        chain._pending_eps = []
        chain._device_history_bytes = 0
        chain._leapfrog_chunks = [np.asarray(D["leapfrog_steps"], dtype=int)]
        chain.ES = EpsilonSelector(1.0)
        chain.ES.load_items(D)
        chain._key = make_key(seed)
        chain._step = None
        chain._step_config = None
        chain.display_progress = bool(D["display_progress"])
        chain.ProgressPrinter = ChainProgressPrinter(
            display=chain.display_progress, leading_msg="advancing chain:"
        )

        if posterior is not None:
            dtype = default_float()
            start = theta[-1]
            chain._logp = as_device_logp(posterior, start)
            eps_state = AdaptiveScale(
                value=jnp.asarray(chain.ES.epsilon, dtype),
                avg=jnp.asarray(chain.ES.avg, dtype),
                var=jnp.asarray(chain.ES.var, dtype),
                num=jnp.asarray(int(chain.ES.num), jnp.int32),
                chk_int=jnp.asarray(chain.ES.chk_int, jnp.int32),
            )
            chain._state = HmcState(
                theta=jnp.asarray(start, dtype),
                logp=jnp.asarray(chain._prob_chunks[0][-1], dtype),
                eps=eps_state,
                key=chain._key,
                failed=jnp.asarray(False),
                inv_temp=jnp.asarray(chain.inv_temp, dtype),
                steps=jnp.asarray(chain.steps, jnp.int32),
            )
        else:
            chain._logp = None
            chain._state = None
        return chain
