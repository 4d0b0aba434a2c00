"""Compiled affine-invariant ensemble (Goodman & Weare stretch-move) kernel.

JAX rebuild of the reference ``EnsembleSampler`` update
(reference: inference/mcmc/ensemble.py:182-210). The reference advances
walkers **sequentially** against the live ensemble; here the standard
red/black half-ensemble variant is used (same stationary distribution,
fully vectorised): each iteration updates the first half of the walkers
using partners from the second half, then the second half using partners
from the freshly-updated first half. Posterior evaluations are vmapped
across walkers, so wall-clock per iteration is one batched posterior call
per half (times retries).

Per-walker repeat-until-accept with ``max_attempts`` retries and failure
counters (reference: ensemble.py:105,193-205) is kept, implemented as a
masked ``lax.while_loop`` over the half-ensemble.

The stretch variable is sampled as ``z = 0.5 * (x_lwr + x_width * U)^2``
— uniform sampling in sqrt(z), giving the g(z) ~ 1/sqrt(z) density on
[1/alpha, alpha] (reference: ensemble.py:100-103,186).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class EnsembleState(NamedTuple):
    walkers: jnp.ndarray  # (W, P)
    logps: jnp.ndarray    # (W,) tempered log-probabilities
    key: jnp.ndarray
    inv_temp: jnp.ndarray  # () inverse temperature (traced: tempering rungs
                           # can be batched over a vmapped/sharded axis)


class EnsembleOutput(NamedTuple):
    walkers: jnp.ndarray   # (W, P)
    logps: jnp.ndarray     # (W,)
    attempts: jnp.ndarray  # (W,) int32 proposals used this iteration
    failures: jnp.ndarray  # () int32 walkers that exhausted max_attempts


def init_ensemble_state(walkers, logps, key, inv_temp=1.0) -> EnsembleState:
    walkers = jnp.asarray(walkers)
    return EnsembleState(
        walkers=walkers,
        logps=jnp.asarray(logps, walkers.dtype),
        key=key,
        inv_temp=jnp.asarray(inv_temp, walkers.dtype),
    )


def make_ensemble_step(
    logp_fn,
    *,
    n_walkers: int,
    alpha: float = 2.0,
    max_attempts: int = 100,
    bounds_reflect=None,
    retry: bool = True,
):
    """
    Build the compiled one-iteration update (all walkers refreshed once).

    :param logp_fn: traceable ``theta -> log-probability`` for one walker.
    :param retry: with True (default), each walker re-proposes until
        acceptance, matching the reference (reference: ensemble.py:193-205).
        With False each walker makes a single stretch-move proposal per
        iteration, keeping its position on rejection — the standard
        Goodman & Weare update — which wastes no work under vmap (the retry
        loop reruns every walker lane until the slowest lane accepts).
    """
    x_lwr = (2.0 / alpha) ** 0.5
    x_width = (2.0 * alpha) ** 0.5 - x_lwr
    batched_logp = jax.vmap(logp_fn)
    half = n_walkers // 2

    def update_half(key, movers, mover_logps, anchors, inv_temp):
        """Stretch-move update of ``movers`` using partners from ``anchors``."""
        h, n_params = movers.shape
        n_anchor = anchors.shape[0]
        dtype = movers.dtype

        class Carry(NamedTuple):
            key: jnp.ndarray
            movers: jnp.ndarray
            logps: jnp.ndarray
            accepted: jnp.ndarray
            attempts: jnp.ndarray

        def cond(c: Carry):
            return ((~c.accepted) & (c.attempts < max_attempts)).any()

        def body(c: Carry):
            key, k_j, k_z, k_u = jax.random.split(c.key, 4)
            # per-walker cap: an exhausted walker stops proposing even
            # while other lanes are still active (reference gives up per
            # walker at max_attempts, reference: ensemble.py:193-205)
            active = (~c.accepted) & (c.attempts < max_attempts)

            j = jax.random.randint(k_j, (h,), 0, n_anchor)
            partners = anchors[j]

            u = jax.random.uniform(k_z, (h,), dtype)
            z = 0.5 * (x_lwr + x_width * u) ** 2

            # stretch move Y = X_j + z (X_k - X_j): the mover's offset from
            # its partner is scaled by z (reference: ensemble.py:186-190)
            proposals = partners + z[:, None] * (c.movers - partners)
            if bounds_reflect is not None:
                proposals = jax.vmap(bounds_reflect)(proposals)

            prop_logps = batched_logp(proposals) * inv_temp
            log_q = (n_params - 1) * jnp.log(z) + prop_logps - c.logps
            accept = jax.random.uniform(k_u, (h,), dtype) <= jnp.exp(log_q)

            take = active & accept
            movers = jnp.where(take[:, None], proposals, c.movers)
            logps = jnp.where(take, prop_logps, c.logps)
            attempts = c.attempts + active.astype(jnp.int32)
            return Carry(key, movers, logps, c.accepted | take, attempts)

        init = Carry(
            key=key,
            movers=movers,
            logps=mover_logps,
            accepted=jnp.zeros(h, bool),
            attempts=jnp.zeros(h, jnp.int32),
        )
        if retry:
            final = lax.while_loop(cond, body, init)
            return final.movers, final.logps, final.attempts, ~final.accepted
        final = body(init)
        # single-proposal mode: rejection keeps the old position and is a
        # valid transition, not a failure
        return (
            final.movers,
            final.logps,
            final.attempts,
            jnp.zeros(h, bool),
        )

    def step(state: EnsembleState):
        key, k_a, k_b = jax.random.split(state.key, 3)

        first, second = state.walkers[:half], state.walkers[half:]
        lp_first, lp_second = state.logps[:half], state.logps[half:]

        first, lp_first, att_a, fail_a = update_half(
            k_a, first, lp_first, second, state.inv_temp
        )
        second, lp_second, att_b, fail_b = update_half(
            k_b, second, lp_second, first, state.inv_temp
        )

        walkers = jnp.concatenate([first, second], axis=0)
        logps = jnp.concatenate([lp_first, lp_second])
        attempts = jnp.concatenate([att_a, att_b])
        failures = fail_a.sum().astype(jnp.int32) + fail_b.sum().astype(jnp.int32)

        new_state = EnsembleState(
            walkers=walkers, logps=logps, key=key, inv_temp=state.inv_temp
        )
        return new_state, EnsembleOutput(walkers, logps, attempts, failures)

    return step


@partial(jax.jit, static_argnums=(0, 2, 3))
def run_steps(step, state, n_steps: int, store: bool = True):
    """Scan ``step`` for ``n_steps`` iterations. With ``store`` (default)
    the per-step outputs are stacked and returned; with ``store=False``
    nothing is materialised in device memory beyond the final state."""
    if store:
        return lax.scan(lambda s, _: step(s), state, None, length=n_steps)
    return lax.scan(
        lambda s, _: (step(s)[0], None), state, None, length=n_steps
    )
