"""Parallel tempering and chain pools.

JAX rebuild of the reference process-per-chain replica exchange
(reference: inference/mcmc/parallel.py:33-384). The reference spawns one OS
process per temperature rung and exchanges positions through pipes; here all
rungs advance inside a **single compiled program** — the per-rung states are
stacked into one pytree (the inverse temperature is a state field, so rungs
at different temperatures share the compiled step) and the step is ``vmap``-ed
over the rung axis. Swap proposals use the same ``tight_pairs`` pairing and
Metropolis test ``U <= exp(-d(beta) * d(logP))`` (reference:
parallel.py:162-231), executed on the host between scan segments with a
single device round-trip for the (N_rungs, P) position block.

A sharded multi-chip variant (rungs laid out over a ``jax.sharding.Mesh``
with ``ppermute`` swaps) lives in ``inference_tpu.parallel.tempering``.
"""

import sys
from time import time
from warnings import warn

import numpy as np
import jax
import jax.numpy as jnp


class ChainPool:
    """
    Data-parallel advancement of independent chains
    (reference: parallel.py:15-30 uses a multiprocessing.Pool; here each
    chain's sampling loop is already a compiled device program, so the pool
    simply drives them in turn — for thousands of homogeneous chains use
    ``inference_tpu.parallel.ChainArray``, which vmaps one compiled step
    over the whole batch).
    """

    def __init__(self, chains):
        self.chains = chains
        self.pool_size = len(self.chains)

    def advance(self, n: int):
        for chain in self.chains:
            chain._advance_n(n)


class ParallelTempering:
    """
    Replica-exchange ('parallel tempering') sampling over a list of chains
    covering a range of temperatures, sorted in increasing-temperature order.

    Chains of the same sampler class (the common case) are batched into a
    single compiled program vmapped over the rung axis, with sampling and
    swaps fused into one device dispatch per advance. A mixed list of
    sampler classes is also supported (reference: parallel.py:21-60 accepts
    any chain types): each rung then advances through its own compiled
    kernel and swaps are performed on the host.

    :param chains: \
        A list of chain objects (``GibbsChain``, ``PcaChain``,
        ``HamiltonianChain``) sorted by increasing temperature.
    """

    def __init__(self, chains):
        self.chains = list(chains)
        self.N_chains = len(self.chains)
        self.rng = np.random.default_rng()

        cls = type(self.chains[0])
        self._heterogeneous = not all(type(c) is cls for c in self.chains)
        n_params = {c.n_parameters for c in self.chains}
        if len(n_params) != 1:
            raise ValueError(
                "[ ParallelTempering error ] All chains must have the same "
                "number of parameters."
            )

        # the batched path compiles ONE step (from chains[0]) for every
        # rung — any per-rung configuration it would silently override
        # routes the ladder through the per-chain (heterogeneous) path
        if not self._heterogeneous and self.N_chains > 1:
            if not all(
                self._step_config_matches(self.chains[0], c)
                for c in self.chains[1:]
            ):
                self._heterogeneous = True
        if self.N_chains < 2:
            # a single rung has no swap partners; the fused program's
            # pairing would be empty, so run it as a plain chain
            self._heterogeneous = True

        self.temperatures = [1.0 / c.inv_temp for c in self.chains]
        self.inv_temps = [c.inv_temp for c in self.chains]

        self.attempted_swaps = np.identity(self.N_chains)
        self.successful_swaps = np.zeros([self.N_chains, self.N_chains])

        if sorted(self.temperatures) != self.temperatures:
            warn(
                "The list of chain objects passed to ParallelTempering should "
                "be sorted in order of increasing chain temperature."
            )

        if not self._heterogeneous:
            # stack the per-rung states into one pytree and vmap the step
            self._batched_state = jax.tree.map(
                lambda *xs: jnp.stack(xs), *[c._state for c in self.chains]
            )
            self._vstep = jax.vmap(self.chains[0]._get_step())
        else:
            self._batched_state = None
            self._vstep = None
        self._swap_key = jax.random.PRNGKey(
            int(self.rng.integers(0, 2**31 - 1))
        )
        # PCA chains need host-side eigendecompositions mid-run, which rules
        # out fusing many cycles into one compiled program; a mixed list of
        # sampler classes cannot be batched into one program at all
        self._fusable = not self._heterogeneous and not any(
            hasattr(c, "next_update") for c in self.chains
        )
        self._fused_run = self._build_fused_run() if self._fusable else None

    @staticmethod
    def _step_config_matches(a, b) -> bool:
        """Whether two same-class chains share every setting the compiled
        step is specialised on (posterior, bounds/modes, mass, caps) —
        only the state (positions, widths, inv_temp) may differ."""
        if a.posterior is not b.posterior:
            return False
        for attr in (
            "steps",
            "max_attempts",
            "max_tries",
            "alpha",
            "retry",
            "max_depth",
        ):
            if getattr(a, attr, None) != getattr(b, attr, None):
                return False
        ba, bb = getattr(a, "bounds", None), getattr(b, "bounds", None)
        if (ba is None) != (bb is None):
            return False
        if ba is not None and not (
            np.array_equal(ba.lower, bb.lower)
            and np.array_equal(ba.upper, bb.upper)
        ):
            return False
        for attr in ("_non_negative", "_bounded", "_lower", "_upper"):
            va, vb = getattr(a, attr, None), getattr(b, attr, None)
            if (va is None) != (vb is None):
                return False
            if va is not None and not np.array_equal(va, vb):
                return False
        ma, mb = getattr(a, "mass", None), getattr(b, "mass", None)
        if (ma is None) != (mb is None):
            return False
        if ma is not None and not np.array_equal(
            np.asarray(ma.inv_mass), np.asarray(mb.inv_mass)
        ):
            return False
        return True

    # ------------------------------------------------------------------ #
    # advancement
    # ------------------------------------------------------------------ #
    def _build_fused_run(self):
        """
        One compiled program for a whole advance: ``lax.scan`` over swap
        cycles, each cycle being ``swap_interval`` sampler steps followed by
        an on-device Metropolis swap using host-precomputed pairings. The
        host sees the device exactly once per ``advance`` call — the
        reference pays two pipe round-trips per cycle
        (reference: parallel.py:233-281).
        """
        vstep = self._vstep
        n_rungs = self.N_chains

        def swap_on_device(state, pair_row, key):
            """pair_row: (P2, 2) int32 rung indices proposed for exchange."""
            theta, logp, inv_t = state.theta, state.logp, state.inv_temp
            i = pair_row[:, 0]
            j = pair_row[:, 1]
            d_beta = inv_t[i] - inv_t[j]
            pi = logp[i] / inv_t[i]
            pj = logp[j] / inv_t[j]
            accept = jax.random.uniform(key, i.shape, logp.dtype) <= jnp.exp(
                -d_beta * (pi - pj)
            )

            # permutation realising the accepted swaps
            perm = jnp.arange(n_rungs)
            perm = perm.at[i].set(jnp.where(accept, j, i))
            perm = perm.at[j].set(jnp.where(accept, i, j))
            new_theta = theta[perm]
            # probabilities are re-tempered at the receiving rung
            new_logp = (logp[perm] / inv_t[perm]) * inv_t
            new_state = state._replace(theta=new_theta, logp=new_logp)
            if hasattr(state, "grad"):
                # a cached tempered gradient rides with the position and
                # re-tempers exactly like logp (grad = inv_temp * raw grad)
                new_state = new_state._replace(
                    grad=(state.grad[perm] / inv_t[perm, None]) * inv_t[:, None]
                )
            return new_state, accept

        def fused(state, pairs, keys, swap_interval: int):
            def cycle(carry, inputs):
                state = carry
                pair_row, key = inputs
                state, outs = jax.lax.scan(
                    lambda s, _: vstep(s), state, None, length=swap_interval
                )
                state, accepted = swap_on_device(state, pair_row, key)
                # an accepted swap replaces the cycle's last recorded sample
                # (the reference replaces each chain's last sample on every
                # swap, reference: parallel.py:222-229) — patch the scan
                # outputs so intermediate-cycle swaps land in the history too
                outs = outs._replace(
                    theta=outs.theta.at[-1].set(state.theta),
                    logp=outs.logp.at[-1].set(state.logp),
                )
                return state, (outs, accepted)

            state, (outs, accepted) = jax.lax.scan(
                cycle, state, (pairs, keys)
            )
            # merge (cycles, swap_interval, rungs, ...) -> (steps, rungs, ...)
            outs = jax.tree.map(
                lambda x: x.reshape((-1,) + x.shape[2:]), outs
            )
            return state, outs, accepted

        return jax.jit(fused, static_argnames="swap_interval")

    def _advance_fused(self, cycles: int, swap_interval: int):
        """Run ``cycles`` sample+swap cycles in one device dispatch."""
        pairs = np.array(
            [self.tight_pairs() for _ in range(cycles)], dtype=np.int32
        )
        self._swap_key, sub = jax.random.split(self._swap_key)
        keys = jax.random.split(sub, cycles)

        state, outs, accepted = self._fused_run(
            self._batched_state, jnp.asarray(pairs), keys, swap_interval
        )
        self._batched_state = state

        outs_np, accepted = jax.device_get((outs, accepted))
        for k, chain in enumerate(self.chains):
            sliced = type(outs_np)(*[f[:, k] for f in outs_np])
            chain._absorb_outputs(sliced)

        accepted = np.asarray(accepted)  # (cycles, P2)
        for c in range(cycles):
            for p, (i, j) in enumerate(pairs[c]):
                self.attempted_swaps[i, j] += 1
                if accepted[c, p]:
                    self.successful_swaps[i, j] += 1

        if hasattr(state, "failed") and bool(np.asarray(state.failed).any()):
            raise ValueError(
                "[ ParallelTempering error ] A chain failed to take a step "
                "within its maximum allowed attempts."
            )

    def _run_batch(self, n: int):
        """Advance all rungs ``n`` steps in one compiled scan."""
        from ._kernels.hmc import run_steps  # generic over step/state pytrees

        state, outs = run_steps(self._vstep, self._batched_state, n)
        self._batched_state = state

        outs_np = jax.device_get(outs)
        for k, chain in enumerate(self.chains):
            sliced = type(outs)(*[f[:, k] for f in outs_np])
            chain._absorb_outputs(sliced)

        if hasattr(state, "failed") and bool(np.asarray(state.failed).any()):
            raise ValueError(
                "[ ParallelTempering error ] A chain failed to take a step "
                "within its maximum allowed attempts."
            )

    def take_steps(self, n: int):
        """Advance all chains ``n`` steps without swap attempts."""
        if self._heterogeneous:
            # mixed sampler classes: each rung advances through its own
            # compiled kernel (one scan dispatch per rung)
            for c in self.chains:
                c._advance_n(n)
            return
        remaining = int(n)
        while remaining > 0:
            run = remaining
            # stop at PCA direction-update boundaries (host eigendecomposition)
            boundaries = [
                c.next_update - c.chain_length
                for c in self.chains
                if hasattr(c, "next_update") and c.next_update > c.chain_length
            ]
            if boundaries:
                run = min(run, min(boundaries))
            self._run_batch(run)
            remaining -= run
            for k, c in enumerate(self.chains):
                if hasattr(c, "next_update") and c.chain_length == c.next_update:
                    c.update_directions()
                    self._batched_state = self._batched_state._replace(
                        directions=self._batched_state.directions.at[k].set(
                            jnp.asarray(c.directions)
                        )
                    )

    # ------------------------------------------------------------------ #
    # swap moves (reference: parallel.py:154-231)
    # ------------------------------------------------------------------ #
    def uniform_pairs(self):
        """Random pairing with uniform sampling across all pairings."""
        proposed = self.rng.permutation(self.N_chains)
        return [p for p in zip(proposed[::2], proposed[1::2])]

    def tight_pairs(self):
        """
        Random pairing where almost all pairs are separated by at most two
        temperature rungs.
        """
        pairs = [
            (i, i + j) for i in range(self.N_chains - 1) for j in [1, 2]
        ][:-1]
        sample = []
        while len(pairs) > 0:
            p = pairs[self.rng.integers(len(pairs))]
            pairs = [k for k in pairs if not any(j in k for j in p)]
            sample.append(p)
        remaining = len(sample) - self.N_chains // 2
        if remaining != 0:
            leftovers = [
                i
                for i in range(self.N_chains)
                if not any(i in p for p in sample)
            ]
            self.rng.shuffle(leftovers)
            sample.extend(
                p if p[0] < p[1] else (p[1], p[0])
                for p in zip(leftovers[::2], leftovers[1::2])
            )
        return sample

    def swap(self):
        """Propose Metropolis position swaps between randomly-paired rungs."""
        if self._heterogeneous:
            positions = np.array(
                [np.asarray(c._state.theta) for c in self.chains]
            )
            probabilities = np.array(
                [float(np.asarray(c._state.logp)) for c in self.chains]
            )
        else:
            positions = np.array(self._batched_state.theta)
            probabilities = np.array(self._batched_state.logp)

        proposed_swaps = self.tight_pairs()
        for pair in proposed_swaps:
            self.attempted_swaps[pair] += 1

        changed = False
        perm = np.arange(len(self.chains))
        for i, j in proposed_swaps:
            dt = self.inv_temps[i] - self.inv_temps[j]
            pi = probabilities[i] / self.inv_temps[i]
            pj = probabilities[j] / self.inv_temps[j]
            dp = pi - pj

            if self.rng.random() <= np.exp(-dt * dp):
                pos_i = positions[i].copy()
                positions[i] = positions[j]
                positions[j] = pos_i
                probabilities[i] = pj * self.inv_temps[i]
                probabilities[j] = pi * self.inv_temps[j]
                perm[[i, j]] = perm[[j, i]]
                self.successful_swaps[i, j] += 1
                changed = True

        if changed:
            if self._heterogeneous:
                for k, chain in enumerate(self.chains):
                    dtype = chain._state.theta.dtype
                    chain._state = chain._state._replace(
                        theta=jnp.asarray(positions[k], dtype),
                        logp=jnp.asarray(probabilities[k], dtype),
                    )
                    if perm[k] != k and hasattr(chain._state, "grad"):
                        # the partner rung may carry no gradient to hand
                        # over — recompute the cache at the new position
                        # (rungs outside accepted pairs keep their cache:
                        # a refresh costs P+1 posterior calls under the
                        # finite-difference gradient fallback)
                        chain._refresh_state_grad()
            else:
                dtype = self._batched_state.theta.dtype
                self._batched_state = self._batched_state._replace(
                    theta=jnp.asarray(positions, dtype),
                    logp=jnp.asarray(probabilities, dtype),
                )
                if hasattr(self._batched_state, "grad"):
                    g = np.asarray(self._batched_state.grad)
                    inv_t = np.asarray(self.inv_temps, dtype=float)
                    new_g = (g[perm] / inv_t[perm, None]) * inv_t[:, None]
                    self._batched_state = self._batched_state._replace(
                        grad=jnp.asarray(new_g, dtype)
                    )
            for k, chain in enumerate(self.chains):
                chain._consolidated_theta()[-1, :] = positions[k]
                chain._consolidated_probs()[-1] = probabilities[k]

    def advance(self, n: int, swap_interval: int = 10):
        """
        Advance each chain ``n`` steps, attempting swaps every
        ``swap_interval`` steps.
        """
        total_cycles = n // swap_interval

        if self._fusable and total_cycles > 0:
            # power-of-two cycle chunks keep the compiled-shape set small
            remaining = total_cycles
            t_start = time()
            done = 0
            while remaining > 0:
                chunk = 1 << (remaining.bit_length() - 1)
                chunk = min(chunk, 512)
                self._advance_fused(chunk, swap_interval)
                remaining -= chunk
                done += chunk
                dt = time() - t_start
                pct = int(100 * done / total_cycles)
                eta = int(dt * (total_cycles / done - 1))
                sys.stdout.write(
                    f"\r  [ Running ParallelTempering - {pct}% complete   "
                    f"ETA: {eta} sec ]    "
                )
                sys.stdout.flush()
        else:
            for _ in range(total_cycles):
                self.take_steps(swap_interval)
                self.swap()

        if n % swap_interval != 0:
            self.take_steps(n % swap_interval)

        sys.stdout.write(
            "\r  [ Running ParallelTempering - complete! ]                    \n"
        )
        sys.stdout.flush()

    def run_for(self, minutes=0, hours=0, swap_interval: int = 10):
        """Advance all chains for a chosen amount of wall-clock time."""
        run_time = (hours * 60.0 + minutes) * 60.0
        start_time = time()
        end_time = start_time + run_time

        t1 = time()
        if self._fusable:
            self._advance_fused(1, swap_interval)
        else:
            self.take_steps(swap_interval)
            self.swap()
        t2 = time()

        # cycles chosen to give a print-out roughly every 2 seconds,
        # rounded to a power of two to bound the compiled-shape set
        N = max(1, int(2.0 / max(t2 - t1, 1e-9)))
        N = 1 << (N.bit_length() - 1)

        while time() < end_time:
            if self._fusable:
                self._advance_fused(min(N, 512), swap_interval)
            else:
                for _ in range(N):
                    self.take_steps(swap_interval)
                    self.swap()
            seconds_remaining = end_time - time()
            m, s = divmod(max(seconds_remaining, 0), 60)
            h, m = divmod(m, 60)
            sys.stdout.write(
                f"\r  [ Running ParallelTempering - time remaining: "
                f"%d:%02d:%02d ]    " % (h, m, s)
            )
            sys.stdout.flush()

        sys.stdout.write(
            "\r  [ Running ParallelTempering - complete! ]                    \n"
        )
        sys.stdout.flush()

    # ------------------------------------------------------------------ #
    # diagnostics & teardown
    # ------------------------------------------------------------------ #
    def swap_diagnostics(self):
        """Plot acceptance rates of position swaps between the chains."""
        import matplotlib.pyplot as plt
        from ..plotting import transition_matrix_plot

        rate_matrix = self.successful_swaps / self.attempted_swaps.clip(min=1)

        pairs = [
            (i, i + j)
            for j in range(1, self.N_chains)
            for i in range(self.N_chains - j)
        ]
        total_swaps = np.zeros(self.N_chains)
        for i, j in pairs:
            total_swaps[i] += self.successful_swaps[i, j]
            total_swaps[j] += self.successful_swaps[i, j]

        fig = plt.figure(figsize=(10, 5))
        ax1 = fig.add_subplot(121)
        transition_matrix_plot(
            axis=ax1,
            matrix=rate_matrix,
            exclude_diagonal=True,
            upper_triangular=True,
        )
        ax1.set_xlabel("chain number")
        ax1.set_ylabel("chain number")
        ax1.set_title("acceptance rate of chain position swaps")

        ax2 = fig.add_subplot(122)
        ax2.bar(range(1, self.N_chains + 1), total_swaps)
        ax2.set_ylim([0, None])
        ax2.set_xlabel("chain number")
        ax2.set_ylabel("total successful position swaps")

        plt.tight_layout()
        plt.show()

    def _sync_states(self):
        """Unstack the batched device state back into the chain objects
        (no-op on the heterogeneous path, where each chain already owns
        its live state)."""
        if self._batched_state is None:
            return
        for k, chain in enumerate(self.chains):
            chain._state = jax.tree.map(lambda x, k=k: x[k], self._batched_state)

    def return_chains(self):
        """Return the chain objects with their final device states."""
        self._sync_states()
        return self.chains

    def shutdown(self):
        """Release the batched device state (API parity: the reference
        terminates its worker processes here)."""
        self._sync_states()
