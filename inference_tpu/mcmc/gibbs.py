"""Metropolis-Hastings and Gibbs samplers.

JAX rebuild of the reference ``MetropolisChain`` / ``GibbsChain``
(reference: inference/mcmc/gibbs.py:220-656). The user-facing API is
preserved (constructor signature, ``advance``, ``get_*`` burn/thin slicing,
``set_non_negative`` / ``set_boundaries``, ``mode``, diagnostics, ``.npz``
save/load with the reference's ``param_{i}...`` key layout); the sampling
loop itself compiles to a ``lax.scan`` over the kernels in
``inference_tpu.mcmc._kernels.metropolis``.

Proposal-width adaptation history (the reference ``Parameter.sigma_values`` /
``sigma_checks`` lists, reference: gibbs.py:36-37) is reconstructed on the
host from the per-step width traces returned by the device kernel: check
positions are therefore recorded at step granularity rather than
mid-step (a documented, diagnostics-only delta).
"""

from warnings import warn

import numpy as np
import jax.numpy as jnp

from ..utils import (
    ChainProgressPrinter,
    effective_sample_size,
    make_key,
    default_float,
    as_device_logp,
)
from .base import MarkovChain
from ._kernels.metropolis import (
    MetropolisState,
    ProposalModes,
    init_metropolis_state,
    make_metropolis_step,
    make_gibbs_step,
    run_steps,
    MH_TARGET,
    GIBBS_TARGET,
    WIDTH_GROWTH,
    WIDTH_POWER,
    MAX_TRIES,
)
from ._kernels.common import AdaptiveScale


class MetropolisChain(MarkovChain):
    """
    Metropolis-Hastings sampling with an adaptive multivariate-normal
    proposal distribution.

    :param posterior: \
        A callable which takes the vector of model parameters and returns
        the posterior log-probability.

    :param start: \
        Parameter vector at which the chain starts.

    :param widths: \
        Initial proposal-distribution standard deviations per parameter.
        Defaults to 5% of the starting values (or 1 where a start value
        is zero).

    :param temperature: \
        Chain temperature (used by parallel tempering).

    :param display_progress: \
        Whether to print progress/ETA messages during sampling.

    :param seed: \
        Optional integer PRNG seed.
    """

    target_rate = MH_TARGET

    def __init__(
        self,
        posterior: callable,
        start,
        widths=None,
        temperature: float = 1.0,
        display_progress: bool = True,
        seed=None,
    ):
        self.inv_temp = 1.0 / temperature
        self.temperature = temperature
        self._key = make_key(seed)
        self._step = None
        self._state = None
        self.chain_length = 1
        self.max_tries = MAX_TRIES
        self._pending_sigmas = []
        self._device_history_bytes = 0

        if posterior is not None:
            self.posterior = posterior
            start = np.asarray(start, dtype=float).flatten()
            self._validate_posterior(posterior=posterior, start=start)
            if widths is None:
                widths = np.array([abs(v) * 0.05 if v != 0 else 1.0 for v in start])
            else:
                # scalars broadcast to all parameters
                widths = np.broadcast_to(
                    np.asarray(widths, dtype=float).flatten(), start.shape
                ).copy()

            self.n_parameters = start.size
            self._init_modes()
            dtype = default_float()
            self._logp = as_device_logp(posterior, start)
            p0 = float(self._logp(jnp.asarray(start, dtype))) * self.inv_temp
            if not np.isfinite(p0):
                raise ValueError(
                    f"[ {self.__class__.__name__} error ] The posterior "
                    f"log-probability is non-finite at the given start point."
                )
            self._state = init_metropolis_state(
                jnp.asarray(start, dtype),
                p0,
                jnp.asarray(widths, dtype),
                self._key,
                inv_temp=self.inv_temp,
            )
            self._theta_chunks = [start.reshape(1, -1)]
            self._prob_chunks = [np.array([p0])]
            self._last_widths = widths.copy()
            self.sigma_values = [[w] for w in widths]
            self.sigma_checks = [[0.0] for _ in widths]
        else:
            self.posterior = None
            self._logp = None

        self.display_progress = display_progress
        self.ProgressPrinter = ChainProgressPrinter(
            display=self.display_progress, leading_msg="advancing chain:"
        )

    # ------------------------------------------------------------------ #
    # proposal modes
    # ------------------------------------------------------------------ #
    def _init_modes(self):
        self._non_negative = np.zeros(self.n_parameters, bool)
        self._bounded = np.zeros(self.n_parameters, bool)
        self._lower = np.zeros(self.n_parameters)
        self._upper = np.ones(self.n_parameters)

    def _device_modes(self) -> ProposalModes:
        dtype = default_float()
        return ProposalModes(
            non_negative=jnp.asarray(self._non_negative),
            bounded=jnp.asarray(self._bounded),
            lower=jnp.asarray(self._lower, dtype),
            upper=jnp.asarray(self._upper, dtype),
        )

    def set_non_negative(self, parameter: int, flag=True):
        """Constrain a particular parameter to non-negative values."""
        if not isinstance(flag, bool):
            warn("non_negative must have a boolean value")
            return
        self._non_negative[parameter] = flag
        self._step = None

    def set_boundaries(self, parameter: int, boundaries, remove=False):
        """Constrain a particular parameter to reflecting boundaries."""
        if remove:
            self._bounded[parameter] = False
            self._lower[parameter] = 0.0
            self._upper[parameter] = 1.0
        else:
            lower, upper = boundaries
            if lower < upper:
                self._bounded[parameter] = True
                self._lower[parameter] = lower
                self._upper[parameter] = upper
            else:
                warn("Upper limit must be greater than lower limit")
                return
        self._step = None

    # ------------------------------------------------------------------ #
    # device execution
    # ------------------------------------------------------------------ #
    def _build_step(self):
        return make_metropolis_step(self._logp, self._device_modes())

    def _get_step(self):
        if self._step is None:
            self._step = self._build_step()
        return self._step

    def _run_chunk(self, n: int):
        if self.posterior is None or self._logp is None:
            raise ValueError(
                f"[ {self.__class__.__name__} error ] Cannot advance a chain "
                f"loaded without a 'posterior' callable."
            )
        state, outs = run_steps(self._get_step(), self._state, n)
        self._state = state
        self._absorb_outputs(outs)

    def _absorb_outputs(self, outs):
        """Append a chunk of outputs to the history. Chunks stay on the
        device until a host view is requested (get_sample etc.) or the
        device-history budget is exceeded — sampling throughput is decoupled
        from history transfer, and transfers happen in consolidated blocks."""
        from ..utils.history import DEVICE_HISTORY_LIMIT

        start_step = self.chain_length
        self._theta_chunks.append(outs.theta)
        self._prob_chunks.append(outs.logp)
        self.chain_length += int(outs.logp.shape[0])
        self._pending_sigmas.append((outs.sigmas, start_step))
        if not isinstance(outs.logp, np.ndarray):
            self._device_history_bytes += outs.theta.nbytes + outs.logp.nbytes
        if self._device_history_bytes > DEVICE_HISTORY_LIMIT:
            self._consolidated_theta()
            self._consolidated_probs()
            self._drain_width_trace()

    def _fetch_history(self):
        """Move any device-held history chunks to the host (one transfer)."""
        import jax

        if self._device_history_bytes > 0:
            self._theta_chunks, self._prob_chunks = jax.device_get(
                (self._theta_chunks, self._prob_chunks)
            )
            self._theta_chunks = [np.asarray(c) for c in self._theta_chunks]
            self._prob_chunks = [np.asarray(c) for c in self._prob_chunks]
            self._device_history_bytes = 0

    def _drain_width_trace(self):
        """Process deferred per-step width traces into the host-side
        ``sigma_values``/``sigma_checks`` change-point logs."""
        if not self._pending_sigmas:
            return
        import jax

        pending, self._pending_sigmas = self._pending_sigmas, []
        for sigmas, start_step in jax.device_get(pending):
            self._record_width_trace(np.asarray(sigmas), int(start_step))

    def _record_width_trace(self, sigmas: np.ndarray, start_step: int):
        """Absorb the per-step width trace, logging change points."""
        for i in range(self.n_parameters):
            prev = self._last_widths[i]
            col = sigmas[:, i]
            changed = np.nonzero(col != np.concatenate([[prev], col[:-1]]))[0]
            for j in changed:
                self.sigma_values[i].append(float(col[j]))
                self.sigma_checks[i].append(float(start_step + j + 1))
            self._last_widths[i] = col[-1]

    # ------------------------------------------------------------------ #
    # host history views
    # ------------------------------------------------------------------ #
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

    @property
    def probs(self):
        return list(self._consolidated_probs())

    def get_last(self) -> np.ndarray:
        return self._consolidated_theta()[-1].astype(np.float64)

    def replace_last(self, theta):
        theta = np.asarray(theta, dtype=float)
        self._consolidated_theta()[-1, :] = theta
        self._state = self._state._replace(
            theta=jnp.asarray(theta, self._state.theta.dtype)
        )

    def replace_last_probability(self, logp: float):
        self._consolidated_probs()[-1] = logp
        self._state = self._state._replace(
            logp=jnp.asarray(logp, self._state.logp.dtype)
        )

    def get_parameter(self, index: int, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return sample values for a chosen parameter with burn/thin slicing."""
        return self._consolidated_theta()[burn::thin, index].copy()

    def get_probabilities(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return the log-probability for each step with burn/thin slicing."""
        return self._consolidated_probs()[burn::thin].copy()

    def get_sample(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        """Return the sample as an (n_samples, n_parameters) array."""
        return self._consolidated_theta()[burn::thin].copy()

    def mode(self) -> np.ndarray:
        """Return the sample with the highest posterior probability."""
        probs = self._consolidated_probs()
        return self._consolidated_theta()[probs.argmax()]

    # ------------------------------------------------------------------ #
    # diagnostics
    # ------------------------------------------------------------------ #
    def estimate_burn_in(self) -> int:
        """
        Burn-in estimate: the later of the first step in the top 1% of
        log-probabilities and the proposal-width stabilisation point
        (reference: gibbs.py:577-592).
        """
        self._drain_width_trace()
        probs = self._consolidated_probs()
        prob_estimate = np.argmax(probs > np.percentile(probs, 99))
        width_estimates = []
        for i in range(self.n_parameters):
            vals = np.abs(
                (np.array(self.sigma_values[i])[::-1] / self._last_widths[i]) - 1.0
            )
            chks = np.array(self.sigma_checks[i])[::-1]
            width_estimates.append(chks[np.argmax(vals > 0.15)])
        return int(max(prob_estimate, float(np.mean(width_estimates))))

    def plot_diagnostics(self, show=True, filename=None):
        """
        Plot the log-probability history, proposal-width adjustment summary
        and per-parameter effective sample sizes
        (reference: gibbs.py:405-519).
        """
        from ..utils.figures import (
            ess_panel,
            finish_figure,
            logprob_history_panel,
            percent_change_panel,
            summary_text_panel,
        )

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
        percent_change_panel(
            fig.add_subplot(222),
            self.sigma_values,
            self.sigma_checks,
            self.chain_length,
        )
        ess_panel(fig.add_subplot(223), param_ESS, histogram_above=10**9)
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
    # reference: gibbs.py:162-217,521-575)
    # ------------------------------------------------------------------ #
    def save(self, filename: str):
        self._drain_width_trace()
        theta = self._consolidated_theta()
        widths_state: AdaptiveScale = self._state.widths
        avg = np.asarray(widths_state.avg)
        var = np.asarray(widths_state.var)
        num = np.asarray(widths_state.num)
        chk = np.asarray(widths_state.chk_int)
        tries = np.asarray(self._state.try_count)

        items = {
            "chain_length": self.chain_length,
            "n_parameters": self.n_parameters,
            "probs": self._consolidated_probs(),
            "inv_temp": self.inv_temp,
            "display_progress": self.display_progress,
        }
        for i in range(self.n_parameters):
            p = f"param_{i}"
            items |= {
                f"{p}samples": theta[:, i],
                f"{p}sigma": self._last_widths[i],
                f"{p}avg": avg[i],
                f"{p}var": var[i],
                f"{p}num": num[i],
                f"{p}sigma_values": self.sigma_values[i],
                f"{p}sigma_checks": self.sigma_checks[i],
                f"{p}try_count": tries[i],
                f"{p}last_update": 0,
                f"{p}target_rate": self.target_rate,
                f"{p}max_tries": self.max_tries,
                f"{p}chk_int": chk[i],
                f"{p}growth_factor": WIDTH_GROWTH,
                f"{p}adjust_rate": WIDTH_POWER,
                f"{p}_non_negative": self._non_negative[i],
                f"{p}bounded": self._bounded[i],
                f"{p}upper": self._upper[i],
                f"{p}lower": self._lower[i],
                f"{p}width": self._upper[i] - self._lower[i]
                if self._bounded[i]
                else 0.0,
            }
        np.savez(filename, **items)

    @classmethod
    def load(cls, filename: str, posterior=None, seed=None):
        D = np.load(filename)
        chain = cls(
            posterior=None,
            start=None,
            widths=None,
            display_progress=bool(D["display_progress"]),
        )
        chain.posterior = posterior
        chain.chain_length = int(D["chain_length"])
        chain.n_parameters = int(D["n_parameters"])
        chain.inv_temp = float(D["inv_temp"])
        chain.temperature = 1.0 / chain.inv_temp
        chain._prob_chunks = [np.asarray(D["probs"], dtype=float)]

        n = chain.n_parameters
        theta = np.stack(
            [np.asarray(D[f"param_{i}samples"], dtype=float) for i in range(n)],
            axis=1,
        )
        chain._theta_chunks = [theta]
        chain._init_modes()
        chain._last_widths = np.array(
            [float(D[f"param_{i}sigma"]) for i in range(n)]
        )
        chain.sigma_values = [list(D[f"param_{i}sigma_values"]) for i in range(n)]
        chain.sigma_checks = [list(D[f"param_{i}sigma_checks"]) for i in range(n)]
        for i in range(n):
            chain._non_negative[i] = bool(D[f"param_{i}_non_negative"])
            chain._bounded[i] = bool(D[f"param_{i}bounded"])
            if chain._bounded[i]:
                chain._lower[i] = float(D[f"param_{i}lower"])
                chain._upper[i] = float(D[f"param_{i}upper"])

        chain._key = make_key(seed)
        dtype = default_float()
        widths_state = AdaptiveScale(
            value=jnp.asarray(chain._last_widths, dtype),
            avg=jnp.asarray(
                [float(D[f"param_{i}avg"]) for i in range(n)], dtype
            ),
            var=jnp.asarray(
                [float(D[f"param_{i}var"]) for i in range(n)], dtype
            ),
            num=jnp.asarray(
                [int(float(D[f"param_{i}num"])) for i in range(n)], jnp.int32
            ),
            chk_int=jnp.asarray(
                [int(D[f"param_{i}chk_int"]) for i in range(n)], jnp.int32
            ),
        )
        chain._state = MetropolisState(
            theta=jnp.asarray(theta[-1], dtype),
            logp=jnp.asarray(chain._prob_chunks[0][-1], dtype),
            widths=widths_state,
            try_count=jnp.asarray(
                [int(D[f"param_{i}try_count"]) for i in range(n)], jnp.int32
            ),
            key=chain._key,
            inv_temp=jnp.asarray(chain.inv_temp, dtype),
        )
        if posterior is not None:
            chain._logp = as_device_logp(posterior, theta[-1])
        return chain


class GibbsChain(MetropolisChain):
    """
    Gibbs sampling: each step is a sweep of 1D Metropolis-Hastings updates,
    one per parameter, with per-parameter proposal-width adaptation targeting
    a 50% acceptance rate (reference: gibbs.py:595-656).

    Constructor arguments are identical to ``MetropolisChain``.
    """

    target_rate = GIBBS_TARGET

    def _build_step(self):
        return make_gibbs_step(
            self._logp,
            self._device_modes(),
            target_rate=self.target_rate,
        )
