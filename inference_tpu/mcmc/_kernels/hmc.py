"""Compiled Hamiltonian Monte-Carlo kernel.

JAX rebuild of the reference HMC step
(reference: inference/mcmc/hmc/__init__.py:127-194). The entire sampling run
compiles to one ``lax.scan``:

- the leapfrog integrator is a ``lax.fori_loop`` over a per-proposal jittered
  step count ``n_steps = int(steps * (1 + (U - 0.5) * 0.2))``
  (reference: hmc/__init__.py:137);
- the repeat-until-accept retry loop is a bounded ``lax.while_loop`` with
  ``max_attempts`` trips (reference: hmc/__init__.py:132), with failure
  recorded in the state instead of raising (the host facade raises);
- step-size adaptation (reference: hmc/epsilon.py) is a branchless
  ``AdaptiveScale`` update inside the loop;
- gradients come from ``jax.grad`` of the user posterior (replacing both the
  user-supplied gradient and the finite-difference fallback).

The step function is pure ``(state) -> (state, output)`` over a pytree, so it
vmaps over thousands of chains and shards over device meshes.
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .common import AdaptiveScale, init_adaptive_scale, submit_accept_prob

# epsilon adaptation constants (reference: hmc/epsilon.py:18-25,41-43)
EPS_TARGET = 0.65
EPS_CHK_INT = 15
EPS_GROWTH = 1.4
EPS_VAR_FLOOR = 0.03
EPS_POWER = 0.15
EPS_MIN_ADJ = 0.5
EPS_MAX_ADJ = 2.0


class HmcState(NamedTuple):
    theta: jnp.ndarray        # (P,) current position
    logp: jnp.ndarray         # () tempered log-probability at theta
    eps: AdaptiveScale        # step-size adaptation state
    key: jnp.ndarray          # PRNG key
    failed: jnp.ndarray       # () bool — max_attempts exhausted at some step
    inv_temp: jnp.ndarray     # () inverse temperature (traced: rungs can be
                              # batched over a vmapped/sharded axis)
    steps: jnp.ndarray        # () int32 nominal leapfrog steps (traced: the
                              # facade can change it without a recompile)


class HmcOutput(NamedTuple):
    theta: jnp.ndarray          # (P,)
    logp: jnp.ndarray           # ()
    leapfrog_steps: jnp.ndarray  # () int32 — total leapfrog steps this sample
    epsilon: jnp.ndarray        # () step size after this sample


def init_hmc_state(theta0, logp0, epsilon, key, inv_temp=1.0, steps=50) -> HmcState:
    theta0 = jnp.asarray(theta0)
    return HmcState(
        theta=theta0,
        logp=jnp.asarray(logp0, theta0.dtype),
        eps=init_adaptive_scale(jnp.asarray(epsilon, theta0.dtype), EPS_CHK_INT),
        key=key,
        failed=jnp.asarray(False),
        inv_temp=jnp.asarray(inv_temp, theta0.dtype),
        steps=jnp.asarray(steps, jnp.int32),
    )


def make_hmc_step(
    logp_fn,
    grad_fn,
    *,
    max_attempts: int = 200,
    mass_velocity=None,
    mass_sample=None,
    bounds_reflect=None,
    retry: bool = True,
):
    """
    Build the compiled single-transition HMC step.

    :param logp_fn: traceable ``theta -> log-probability`` (untempered).
    :param grad_fn: traceable gradient of ``logp_fn``.
    :param max_attempts: proposal retries before flagging failure.
    :param mass_velocity: ``r -> velocity`` map (inverse-mass application).
    :param mass_sample: ``(key, dtype) -> momentum sample``.
    :param bounds_reflect: optional ``theta -> (theta, reflections)`` map for
        bounded leapfrog (position reflection + momentum sign flip,
        reference: hmc/__init__.py:178-194).
    :param retry: with True (default), rejected proposals are re-drawn until
        acceptance, matching the reference's repeat-until-accept behaviour
        (reference: hmc/__init__.py:132-157). With False the step is the
        textbook MH kernel — a single proposal, duplicating the current
        point on rejection — which has no retry loop at all and therefore
        wastes no work when vmapped over large chain batches (under vmap a
        retry loop reruns every lane until the slowest lane accepts).

    The inverse temperature AND the nominal leapfrog step count are read
    from the state: tempering rungs share one compiled program, and the
    facade's ``steps`` attribute can change between calls without triggering
    a recompile (the per-proposal count is already a traced value because of
    the +-10% jitter, reference: hmc/__init__.py:137). Tempering scales both
    the log-probability and the leapfrog force
    (reference: hmc/__init__.py:167,181).
    """
    if mass_velocity is None:
        mass_velocity = lambda r: r
    unit_momentum = mass_sample is None

    def kinetic_energy(r):
        return 0.5 * (r @ mass_velocity(r))

    def leapfrog(t, r, n_steps, epsilon, inv_temp):
        r_step = inv_temp * epsilon
        r = r + (0.5 * r_step) * grad_fn(t)

        def drift_kick(t, r, kick_scale):
            t = t + epsilon * mass_velocity(r)
            if bounds_reflect is not None:
                t, reflections = bounds_reflect(t)
                r = r * reflections
            r = r + (kick_scale * r_step) * grad_fn(t)
            return t, r

        def body(i, carry):
            return drift_kick(*carry, kick_scale=1.0)

        t, r = lax.fori_loop(0, n_steps - 1, body, (t, r))
        t, r = drift_kick(t, r, kick_scale=0.5)
        return t, r

    def step(state: HmcState):
        key, step_key = jax.random.split(state.key)
        dtype = state.theta.dtype
        inv_temp = state.inv_temp

        class Carry(NamedTuple):
            key: jnp.ndarray
            accepted: jnp.ndarray
            attempts: jnp.ndarray
            steps_taken: jnp.ndarray
            eps: AdaptiveScale
            theta: jnp.ndarray
            logp: jnp.ndarray

        def cond(c: Carry):
            return (~c.accepted) & (c.attempts < max_attempts)

        def body(c: Carry):
            key, k_mom, k_steps, k_acc = jax.random.split(c.key, 4)
            epsilon = c.eps.value

            if unit_momentum:  # identity-mass default, like mass_velocity
                r0 = jax.random.normal(k_mom, state.theta.shape, dtype)
            else:
                r0 = mass_sample(k_mom, dtype)
            h0 = kinetic_energy(r0) - state.logp

            # the jitter only sets an integer count: drawn and evaluated
            # in float32 whatever the working dtype, so a float32 and a
            # float64 run of the same key take the same number of steps
            u = jax.random.uniform(k_steps, dtype=jnp.float32)
            n_steps = (
                state.steps.astype(jnp.float32) * (1 + (u - 0.5) * 0.2)
            ).astype(jnp.int32)

            t, r = leapfrog(state.theta, r0, n_steps, epsilon, inv_temp)

            p = logp_fn(t) * inv_temp
            h = kinetic_energy(r) - p
            accept_prob = jnp.exp(h0 - h)

            submitted = jnp.where(
                jnp.isfinite(accept_prob), jnp.minimum(accept_prob, 1.0), 0.0
            )
            eps = submit_accept_prob(
                c.eps,
                submitted,
                target=EPS_TARGET,
                growth_factor=EPS_GROWTH,
                adjust_power=EPS_POWER,
                adjust_min=EPS_MIN_ADJ,
                adjust_max=EPS_MAX_ADJ,
                var_floor=EPS_VAR_FLOOR,
            )

            accepted = (accept_prob >= 1.0) | (
                jax.random.uniform(k_acc, dtype=dtype) <= accept_prob
            )
            return Carry(
                key=key,
                accepted=accepted,
                attempts=c.attempts + 1,
                steps_taken=c.steps_taken + n_steps,
                eps=eps,
                theta=jnp.where(accepted, t, c.theta),
                logp=jnp.where(accepted, p, c.logp),
            )

        init = Carry(
            key=step_key,
            accepted=jnp.asarray(False),
            attempts=jnp.asarray(0, jnp.int32),
            steps_taken=jnp.asarray(0, jnp.int32),
            eps=state.eps,
            theta=state.theta,
            logp=state.logp,
        )
        if retry:
            final = lax.while_loop(cond, body, init)
        else:
            final = body(init)
            # duplicate-on-reject: a rejected single proposal is a valid
            # MH transition, not a failure
            final = final._replace(accepted=jnp.asarray(True))

        new_state = HmcState(
            theta=final.theta,
            logp=final.logp,
            eps=final.eps,
            key=key,
            failed=state.failed | ~final.accepted,
            inv_temp=state.inv_temp,
            steps=state.steps,
        )
        out = HmcOutput(
            theta=final.theta,
            logp=final.logp,
            leapfrog_steps=final.steps_taken,
            epsilon=final.eps.value,
        )
        return new_state, out

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
