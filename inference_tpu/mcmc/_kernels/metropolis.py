"""Compiled Metropolis / Gibbs / PCA-Gibbs kernels.

JAX rebuild of the reference Metropolis-family step loops
(reference: inference/mcmc/gibbs.py:288-307,627-656 and pca.py:150-183).
The repeat-until-accept inner loops become ``lax.while_loop``s, the
componentwise Gibbs sweep a ``lax.fori_loop``, and per-parameter proposal
width adaptation (reference: gibbs.py:88-156) a branchless masked
``AdaptiveScale`` update — so a full sampling run compiles to a single
``lax.scan`` and vmaps over chains.

Proposal-mode semantics per parameter (standard / non-negative ``abs`` /
reflecting-boundary, reference: gibbs.py:88-122) are selected with
``jnp.where`` masks rather than bound methods.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .common import AdaptiveScale, init_adaptive_scale, submit_accept_prob, rescale

# width adaptation constants (reference: gibbs.py:42-46)
MH_TARGET = 0.25       # MetropolisChain target accept rate
GIBBS_TARGET = 0.5     # GibbsChain / PcaChain target accept rate
WIDTH_CHK_INT = 100
WIDTH_GROWTH = 1.75
WIDTH_POWER = 0.25
WIDTH_MIN_ADJ = 0.1
WIDTH_MAX_ADJ = 3.0
MAX_TRIES = 50         # tries before the width is cut to a quarter


class ProposalModes(NamedTuple):
    """Per-parameter proposal behaviour masks (closure constants)."""

    non_negative: jnp.ndarray  # (P,) bool
    bounded: jnp.ndarray       # (P,) bool
    lower: jnp.ndarray         # (P,)
    upper: jnp.ndarray         # (P,)


def default_modes(n_params, dtype):
    return ProposalModes(
        non_negative=jnp.zeros(n_params, bool),
        bounded=jnp.zeros(n_params, bool),
        lower=jnp.zeros(n_params, dtype),
        upper=jnp.ones(n_params, dtype),
    )


class MetropolisState(NamedTuple):
    theta: jnp.ndarray        # (P,) current position
    logp: jnp.ndarray         # () tempered log-probability
    widths: AdaptiveScale     # per-parameter proposal width adaptation
    try_count: jnp.ndarray    # (P,) int32 proposals since last accepted step
    key: jnp.ndarray
    inv_temp: jnp.ndarray     # () inverse temperature (traced: rungs can be
                              # batched over a vmapped/sharded axis)


class MetropolisOutput(NamedTuple):
    theta: jnp.ndarray   # (P,)
    logp: jnp.ndarray    # ()
    sigmas: jnp.ndarray  # (P,) proposal widths after this step


def init_metropolis_state(
    theta0, logp0, widths, key, inv_temp=1.0
) -> MetropolisState:
    theta0 = jnp.asarray(theta0)
    return MetropolisState(
        theta=theta0,
        logp=jnp.asarray(logp0, theta0.dtype),
        widths=init_adaptive_scale(
            jnp.asarray(widths, theta0.dtype), WIDTH_CHK_INT
        ),
        try_count=jnp.zeros(theta0.shape, jnp.int32),
        key=key,
        inv_temp=jnp.asarray(inv_temp, theta0.dtype),
    )


def _apply_modes(prop, prev, modes: ProposalModes):
    """Apply non-negative / reflecting-boundary transforms elementwise."""
    prop = jnp.where(modes.non_negative, jnp.abs(prop), prop)
    width = modes.upper - modes.lower
    d = prop - modes.lower
    q, rem = jnp.divmod(d, width)
    n = q % 2
    reflected = modes.lower + (1 - 2 * n) * rem + n * width
    return jnp.where(modes.bounded, reflected, prop)


def _halve_on_max_tries(widths, try_count, mask_extra=True):
    """
    Increment try counts and cut widths to a quarter once they exceed
    ``MAX_TRIES`` (reference: gibbs.py:91-93). Returns updated
    (widths, try_count). As in the reference, the try count is NOT reset
    by the cut (only by an accepted sample), so past 50 tries the width
    shrinks by 0.25 on every further proposal until one is accepted —
    the reference's deliberate force-acceptance collapse.
    """
    try_count = try_count + jnp.asarray(mask_extra, jnp.int32)
    halve = (try_count > MAX_TRIES) & mask_extra
    return rescale(widths, 0.25, mask=halve), try_count


def make_metropolis_step(logp_fn, modes: ProposalModes, *, retry: bool = True):
    """
    Joint-proposal Metropolis-Hastings step with repeat-until-accept
    (reference: gibbs.py:288-307). Widths adapt only through the
    max-tries halving — the reference's ``MetropolisChain`` never submits
    acceptance statistics. The inverse temperature is read from the state
    so tempering rungs can share one compiled program.

    :param retry: with True (default) proposals repeat until acceptance,
        matching the reference's semantics. With False the step is the
        textbook MH kernel — one proposal, duplicating the current point on
        rejection — which has no retry loop at all and therefore wastes no
        work when vmapped over large chain batches (a retry loop reruns
        every lane until the slowest lane accepts).
    """

    def step(state: MetropolisState):
        key, step_key = jax.random.split(state.key)
        inv_temp = state.inv_temp

        def cond(c):
            return ~c[0]

        def body(c):
            _, theta_prop, p_new, widths, try_count, k = c
            k, k_prop, k_acc = jax.random.split(k, 3)
            widths, try_count = _halve_on_max_tries(widths, try_count)
            eps = jax.random.normal(k_prop, state.theta.shape, state.theta.dtype)
            prop = _apply_modes(
                state.theta + widths.value * eps, state.theta, modes
            )
            p = logp_fn(prop) * inv_temp
            auto = p > state.logp
            accept_prob = jnp.exp(jnp.minimum(p - state.logp, 0.0))
            accepted = auto | (
                jax.random.uniform(k_acc, dtype=state.theta.dtype) < accept_prob
            )
            return (accepted, prop, p, widths, try_count, k)

        init = (
            jnp.asarray(False),
            state.theta,
            state.logp,
            state.widths,
            state.try_count,
            step_key,
        )
        if retry:
            _, theta, logp, widths, _, _ = lax.while_loop(cond, body, init)
        else:
            accepted, theta, logp, widths, _, _ = body(init)
            theta = jnp.where(accepted, theta, state.theta)
            logp = jnp.where(accepted, logp, state.logp)

        new_state = MetropolisState(
            theta=theta,
            logp=logp,
            widths=widths,
            try_count=jnp.zeros_like(state.try_count),  # add_sample resets
            key=key,
            inv_temp=state.inv_temp,
        )
        return new_state, MetropolisOutput(theta, logp, widths.value)

    return step


def make_gibbs_step(
    logp_fn,
    modes: ProposalModes,
    *,
    target_rate: float = GIBBS_TARGET,
    retry: bool = True,
):
    """
    Componentwise Gibbs sweep: one repeat-until-accept 1D Metropolis update
    per parameter per step, with per-parameter acceptance statistics driving
    the width adaptation (reference: gibbs.py:627-656).

    :param retry: with True (default) proposals repeat until acceptance,
        matching the reference's semantics. With False the step is the
        textbook MH kernel — one proposal, duplicating the current point on
        rejection — which has no retry loop at all and therefore wastes no
        work when vmapped over large chain batches (a retry loop reruns
        every lane until the slowest lane accepts).
    """

    def step(state: MetropolisState):
        key, step_key = jax.random.split(state.key)
        inv_temp = state.inv_temp
        n_params = state.theta.shape[0]
        param_ids = jnp.arange(n_params)

        def update_param(i, carry):
            theta, p_old, widths, try_count, k = carry
            onehot = param_ids == i

            def cond(c):
                return ~c[0]

            def body(c):
                _, _, _, widths, try_count, k = c
                k, k_prop, k_acc = jax.random.split(k, 3)
                widths, try_count = _halve_on_max_tries(
                    widths, try_count, mask_extra=onehot
                )
                eps = jax.random.normal(k_prop, dtype=theta.dtype)
                prop_i = theta[i] + widths.value[i] * eps
                prop_vec = _apply_modes(
                    jnp.full_like(theta, prop_i), theta, modes
                )
                theta_try = theta.at[i].set(prop_vec[i])
                p_new = logp_fn(theta_try) * inv_temp
                auto = p_new > p_old
                accept_prob = jnp.exp(jnp.minimum(p_new - p_old, 0.0))
                submitted = jnp.where(auto, 1.0, accept_prob)
                widths = submit_accept_prob(
                    widths,
                    submitted,
                    target=target_rate,
                    growth_factor=WIDTH_GROWTH,
                    adjust_power=WIDTH_POWER,
                    adjust_min=WIDTH_MIN_ADJ,
                    adjust_max=WIDTH_MAX_ADJ,
                    mask=onehot,
                )
                accepted = auto | (
                    jax.random.uniform(k_acc, dtype=theta.dtype) < accept_prob
                )
                return (accepted, theta_try, p_new, widths, try_count, k)

            init = (jnp.asarray(False), theta, p_old, widths, try_count, k)
            if retry:
                _, theta_new, p_new, widths, try_count, k = lax.while_loop(
                    cond, body, init
                )
            else:
                acc, theta_new, p_new, widths, try_count, k = body(init)
                theta_new = jnp.where(acc, theta_new, theta)
                p_new = jnp.where(acc, p_new, p_old)
            return (theta_new, p_new, widths, try_count, k)

        theta, logp, widths, _, _ = lax.fori_loop(
            0,
            n_params,
            update_param,
            (state.theta, state.logp, state.widths, state.try_count, step_key),
        )

        new_state = MetropolisState(
            theta=theta,
            logp=logp,
            widths=widths,
            try_count=jnp.zeros_like(state.try_count),
            key=key,
            inv_temp=state.inv_temp,
        )
        return new_state, MetropolisOutput(theta, logp, widths.value)

    return step


class PcaState(NamedTuple):
    theta: jnp.ndarray        # (P,)
    logp: jnp.ndarray         # ()
    widths: AdaptiveScale     # per-direction proposal width adaptation
    try_count: jnp.ndarray    # (P,) int32
    key: jnp.ndarray
    inv_temp: jnp.ndarray     # ()
    directions: jnp.ndarray   # (P, P) sweep direction i in column i


def init_pca_state(theta0, logp0, widths, key, directions, inv_temp=1.0) -> PcaState:
    base = init_metropolis_state(theta0, logp0, widths, key, inv_temp)
    return PcaState(
        *base, directions=jnp.asarray(directions, jnp.asarray(theta0).dtype)
    )


def make_pca_step(
    logp_fn,
    *,
    target_rate: float = GIBBS_TARGET,
    bounds_reflect=None,
    retry: bool = True,
):
    """
    Gibbs sweep along direction vectors (the eigenvectors of the sample
    covariance, re-estimated periodically on the host between scan segments —
    reference: pca.py:96-183). The direction matrix lives in the state so
    host-side updates don't invalidate the compiled program.
    """

    def step(state: PcaState):
        key, step_key = jax.random.split(state.key)
        inv_temp = state.inv_temp
        n_params = state.theta.shape[0]
        param_ids = jnp.arange(n_params)
        directions = state.directions

        def update_direction(i, carry):
            theta, p_old, widths, try_count, k = carry
            onehot = param_ids == i
            v = directions[:, i]

            def cond(c):
                return ~c[0]

            def body(c):
                _, _, _, widths, try_count, k = c
                k, k_prop, k_acc = jax.random.split(k, 3)
                widths, try_count = _halve_on_max_tries(
                    widths, try_count, mask_extra=onehot
                )
                eps = jax.random.normal(k_prop, dtype=theta.dtype)
                prop = theta + v * (widths.value[i] * eps)
                if bounds_reflect is not None:
                    prop = bounds_reflect(prop)
                p_new = logp_fn(prop) * inv_temp
                auto = p_new > p_old
                accept_prob = jnp.exp(jnp.minimum(p_new - p_old, 0.0))
                submitted = jnp.where(auto, 1.0, accept_prob)
                widths = submit_accept_prob(
                    widths,
                    submitted,
                    target=target_rate,
                    growth_factor=WIDTH_GROWTH,
                    adjust_power=WIDTH_POWER,
                    adjust_min=WIDTH_MIN_ADJ,
                    adjust_max=WIDTH_MAX_ADJ,
                    mask=onehot,
                )
                accepted = auto | (
                    jax.random.uniform(k_acc, dtype=theta.dtype) < accept_prob
                )
                return (accepted, prop, p_new, widths, try_count, k)

            init = (jnp.asarray(False), theta, p_old, widths, try_count, k)
            if retry:
                _, theta_new, p_new, widths, try_count, k = lax.while_loop(
                    cond, body, init
                )
            else:
                acc, theta_new, p_new, widths, try_count, k = body(init)
                theta_new = jnp.where(acc, theta_new, theta)
                p_new = jnp.where(acc, p_new, p_old)
            return (theta_new, p_new, widths, try_count, k)

        theta, logp, widths, _, _ = lax.fori_loop(
            0,
            n_params,
            update_direction,
            (state.theta, state.logp, state.widths, state.try_count, step_key),
        )

        new_state = PcaState(
            theta=theta,
            logp=logp,
            widths=widths,
            try_count=jnp.zeros_like(state.try_count),
            key=key,
            inv_temp=state.inv_temp,
            directions=state.directions,
        )
        return new_state, MetropolisOutput(theta, logp, widths.value)

    return step


@partial(jax.jit, static_argnums=(0, 2, 3))
def run_steps(step, state, n_steps: int, store: bool = True):
    """Scan ``step`` for ``n_steps`` transitions. With ``store`` (default)
    the per-step outputs are stacked and returned; with ``store=False``
    the scan emits no outputs at all — nothing is materialised in device memory
    beyond the final state (the maximum-throughput path)."""
    if store:
        return lax.scan(lambda s, _: step(s), state, None, length=n_steps)
    return lax.scan(
        lambda s, _: (step(s)[0], None), state, None, length=n_steps
    )
