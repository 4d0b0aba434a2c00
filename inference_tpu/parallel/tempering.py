"""Sharded parallel tempering: replica-exchange over a device mesh.

The multi-device form of ``inference_tpu.mcmc.ParallelTempering``:
temperature rungs are laid out along the 'rungs' axis of a ('rungs',
'chains') mesh and swap proposals become **collective permutes**
(``lax.ppermute``, NCCL over NVLink between GPUs) —
the reference's pipe-synchronised process swaps
(reference: inference/mcmc/parallel.py:190-231) with no host round-trip.

Every sampler family of the single-chain facades is available per rung
("hmc", "nuts", "gibbs", "metropolis", "pca", "ensemble" — one kind for all rungs,
since the rungs execute a single SPMD program; mixed-kind ladders run on
the host facade ``mcmc.ParallelTempering`` instead). Each (rung, lane)
pair holds an independent chain (for "ensemble", an independent
sub-ensemble of walkers); swap moves use an even-odd pairing schedule where
partner rungs exchange position/log-probability blocks by ppermute and both
sides reach the same Metropolis decision ``U <= exp(-d(beta) * d(logP))``
(reference: parallel.py:210-231) from a shared folded key, so no extra
communication is needed for the accept bit. Chain lanes swap independently
— the program advances C independent replica-exchange ensembles at once.

Beyond the original reference surface this class also provides per-rung
sample history with ``get_sample``/``get_probabilities``, a wall-clock
``run_for`` driver (reference: parallel.py:283-326), and swap-rate
diagnostics feeding ``transition_matrix_plot``
(reference: parallel.py:328-362).
"""

import sys
from functools import partial
from time import time

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from ..utils import make_key, default_float, as_device_logp
from ..mcmc._kernels import ensemble as ens_kernel
from ._kinds import build_kind, positions_of, with_positions


def _even_odd_perm(n_rungs: int, phase: int):
    """Partner permutation for even-odd replica-exchange pairing."""
    perm = []
    partner = {}
    for i in range(n_rungs):
        j = i + 1 - 2 * (i % 2) if phase == 0 else i - 1 + 2 * (i % 2)
        if 0 <= j < n_rungs:
            partner[i] = j
        else:
            partner[i] = i
        perm.append((i, partner[i]))
    return perm, partner


class ShardedTempering:
    """
    Replica-exchange sampling over a ('rungs', 'chains') device mesh.

    :param posterior: traceable log-probability callable.
    :param start: starting position, shape (n_parameters,).
    :param temperatures: increasing temperature ladder, one per rung. The
        number of rungs must match the mesh's 'rungs' axis size.
    :param n_chains: independent chain lanes per rung (sharded over the
        'chains' mesh axis). For ``kind="ensemble"`` each lane is an
        independent sub-ensemble of ``n_walkers`` walkers.
    :param mesh: a ('rungs', 'chains') mesh (see
        ``inference_tpu.parallel.tempering_mesh``).
    :param kind: sampler family per rung — "hmc" (default), "nuts"
        (No-U-Turn trajectories, beyond the reference), "gibbs",
        "metropolis", "pca" or "ensemble".
    :param widths: initial proposal widths (Metropolis family), or the
        walker-spread scale around ``start`` (ensemble).
    :param epsilon: initial leapfrog step size (hmc).
    :param steps: leapfrog steps per proposal (hmc).
    :param max_depth: maximum trajectory doublings per transition (nuts).
    :param inverse_mass: scalar, (P,) diagonal, or (P, P) matrix inverse
        mass (hmc).
    :param non_negative: per-parameter non-negative proposal folding
        (gibbs/metropolis).
    :param boundaries: (lower, upper) reflecting proposal boundaries
        (gibbs/metropolis).
    :param bounds: optional ``utils.Bounds`` — bounded leapfrog (hmc) or
        reflected stretch moves (ensemble).
    :param n_walkers: walkers per sub-ensemble (ensemble kind).
    :param alpha: stretch-move scale parameter (ensemble kind).
    :param retry: repeat-until-accept proposals (reference semantics) when
        True; textbook duplicate-on-reject when False (default here — with
        thousands of vmapped lanes a retry loop reruns every lane until the
        slowest accepts).
    :param seed: optional PRNG seed.
    :param display_progress: print progress/ETA lines during long drives.
    """

    def __init__(
        self,
        posterior,
        start,
        temperatures,
        n_chains: int,
        mesh,
        kind: str = "hmc",
        *,
        widths=None,
        epsilon: float = 0.1,
        steps: int = 50,
        inverse_mass=None,
        non_negative=None,
        boundaries=None,
        bounds=None,
        n_walkers: int = None,
        alpha: float = 2.0,
        max_depth: int = 10,
        retry: bool = False,
        seed=None,
        display_progress: bool = True,
    ):
        start = np.asarray(start, dtype=float)
        self.n_parameters = start.size
        self.temperatures = np.asarray(temperatures, dtype=float)
        self.n_rungs = self.temperatures.size
        self.n_chains = n_chains
        self.mesh = mesh
        self.kind = kind
        self.display_progress = display_progress

        if mesh.shape["rungs"] != self.n_rungs:
            raise ValueError(
                f"the mesh 'rungs' axis ({mesh.shape['rungs']}) must match "
                f"the number of temperature rungs ({self.n_rungs})"
            )
        if n_chains % mesh.shape["chains"] != 0:
            raise ValueError(
                "n_chains must be divisible by the mesh 'chains' axis size"
            )

        dtype = default_float()
        self._logp = as_device_logp(posterior, start)
        inv_temps = jnp.asarray(1.0 / self.temperatures, dtype)

        if kind in ("gibbs", "metropolis", "pca") and widths is None:
            # the reference's default: 5% of the start point per parameter
            # (reference: gibbs.py:258-259)
            widths = np.where(start != 0, np.abs(start) * 0.05, 1.0)

        key = make_key(seed)
        self._swap_key, init_key, walker_key = jax.random.split(key, 3)
        keys = jax.random.split(init_key, self.n_rungs * n_chains).reshape(
            self.n_rungs, n_chains, -1
        )

        init, step = build_kind(
            kind,
            self._logp,
            self.n_parameters,
            dtype,
            widths=widths,
            epsilon=epsilon,
            steps=steps,
            inverse_mass=inverse_mass,
            non_negative=non_negative,
            boundaries=boundaries,
            bounds=bounds,
            alpha=alpha,
            n_walkers=n_walkers,
            retry=retry,
            max_depth=max_depth,
        )

        if kind == "ensemble":
            spread = 0.05 * np.abs(start) + 0.01 if widths is None else widths
            spread = np.broadcast_to(np.asarray(spread, float), start.shape)
            shape = (self.n_rungs, n_chains, n_walkers, self.n_parameters)
            walkers0 = jnp.asarray(start, dtype) + jnp.asarray(
                spread, dtype
            ) * jax.random.normal(walker_key, shape, dtype)
            logp0 = jax.vmap(jax.vmap(jax.vmap(self._logp)))(walkers0)
            logp0 = logp0 * inv_temps[:, None, None]
            pos0, lp0 = walkers0, logp0
        else:
            pos0 = jnp.broadcast_to(
                jnp.asarray(start, dtype),
                (self.n_rungs, n_chains, self.n_parameters),
            )
            p0 = self._logp(jnp.asarray(start, dtype))
            lp0 = jnp.broadcast_to(p0, (self.n_rungs, n_chains)) * inv_temps[:, None]

        init2 = jax.vmap(
            jax.vmap(init, in_axes=(0, 0, 0, None)), in_axes=(0, 0, 0, 0)
        )
        state = init2(pos0, lp0, keys, inv_temps)

        self._state = self._shard(state)
        self._vstep = jax.vmap(jax.vmap(step))
        self._swap_fns = {
            0: self._build_swap(0),
            1: self._build_swap(1),
        }
        self._fused = self._build_fused()
        self._single = self._build_single()
        self._steps_only = self._build_steps_only()
        self._phase = 0
        self.attempted_swaps = np.identity(self.n_rungs)
        self.successful_swaps = np.zeros((self.n_rungs, self.n_rungs))
        self._history = []
        self._prob_history = []
        self._raw_steps = 0  # unthinned steps offered to _store so far

    # ------------------------------------------------------------------ #
    # sharding / program construction
    # ------------------------------------------------------------------ #
    def _shard(self, state):
        def put(x):
            spec = P("rungs", "chains", *([None] * (x.ndim - 2)))
            return jax.device_put(x, NamedSharding(self.mesh, spec))

        return jax.tree.map(put, state)

    def _state_spec(self):
        return jax.tree.map(
            lambda x: P("rungs", "chains", *([None] * (x.ndim - 2))),
            self._state,
        )

    def _build_swap(self, phase: int):
        mesh = self.mesh
        n_rungs = self.n_rungs
        perm, partner_map = _even_odd_perm(n_rungs, phase)
        partner_arr = jnp.asarray(
            [partner_map[i] for i in range(n_rungs)], jnp.int32
        )
        state_spec = self._state_spec()

        def swap_shard(state, swap_key):
            """Runs inside shard_map: one rung shard per device row."""
            rung = lax.axis_index("rungs")
            pos, logp = positions_of(state)
            inv_temp = state.inv_temp

            # broadcast inv_temp (.., C) against logp (.., C[, W])
            def expand(a):
                return a.reshape(a.shape + (1,) * (logp.ndim - a.ndim))

            pos_o = lax.ppermute(pos, "rungs", perm)
            logp_o = lax.ppermute(logp, "rungs", perm)
            inv_t_o = lax.ppermute(inv_temp, "rungs", perm)

            partner_idx = partner_arr[rung]
            has_partner = partner_idx != rung

            it, it_o = expand(inv_temp), expand(inv_t_o)
            d_beta = it - it_o
            d_logp = logp / it - logp_o / it_o
            accept_prob = jnp.exp(-d_beta * d_logp)

            # shared decision: both partners fold the swap key with the
            # lower rung index, so they draw identical uniforms per lane.
            # The chains-shard index is folded in too — partners share a
            # chain shard, but distinct shards must draw independent
            # uniforms (a replicated key would correlate their lanes)
            pair_id = jnp.minimum(rung, partner_idx)
            u_key = jax.random.fold_in(swap_key, pair_id)
            u_key = jax.random.fold_in(u_key, lax.axis_index("chains"))
            u = jax.random.uniform(u_key, logp.shape, logp.dtype)
            accept = has_partner & (u <= accept_prob)

            new_pos = jnp.where(accept[..., None], pos_o, pos)
            new_logp = jnp.where(accept, (logp_o / it_o) * it, logp)
            new_state = with_positions(state, new_pos, new_logp)
            if hasattr(state, "grad"):
                # cached tempered gradients ride with the positions and
                # re-temper exactly like logp (grad = inv_temp * raw grad)
                grad_o = lax.ppermute(state.grad, "rungs", perm)
                new_state = new_state._replace(
                    grad=jnp.where(
                        accept[..., None],
                        (grad_o / it_o[..., None]) * it[..., None],
                        state.grad,
                    )
                )
            return new_state, accept

        accept_ndim = 3 if self.kind == "ensemble" else 2
        return shard_map(
            swap_shard,
            mesh=mesh,
            in_specs=(state_spec, P()),
            out_specs=(
                state_spec,
                P("rungs", "chains", *([None] * (accept_ndim - 2))),
            ),
            check_vma=False,
        )

    @staticmethod
    def _patch_last(outs, state):
        """Write post-swap positions into the cycle's final recorded sample
        (an accepted swap replaces the last sample, as in the reference)."""
        if isinstance(outs, ens_kernel.EnsembleOutput):
            return outs._replace(
                walkers=outs.walkers.at[-1].set(state.walkers),
                logps=outs.logps.at[-1].set(state.logps),
            )
        return outs._replace(
            theta=outs.theta.at[-1].set(positions_of(state)[0]),
            logp=outs.logp.at[-1].set(positions_of(state)[1]),
        )

    def _build_fused(self):
        """One compiled program for many supercycles: each supercycle is
        (interval steps, phase0 swap, interval steps, phase1 swap) — pair
        phases are static inside the scan body, so every swap is a single
        ppermute with a static permutation."""
        vstep = self._vstep
        swap_fns = self._swap_fns
        patch = self._patch_last

        @partial(jax.jit, static_argnames=("interval", "phase0", "store"))
        def fused(state, keys, interval: int, phase0: int, store: bool):
            def half(state, key, phase):
                state, outs = lax.scan(
                    lambda s, o: (vstep(s)[0], None)
                    if not store
                    else vstep(s),
                    state,
                    None,
                    length=interval,
                )
                state, accept = swap_fns[phase](state, key)
                outs = patch(outs, state) if store else None
                return state, outs, accept

            def body(state, ks):
                state, o1, a1 = half(state, ks[0], phase0)
                state, o2, a2 = half(state, ks[1], 1 - phase0)
                if store:
                    outs = jax.tree.map(
                        lambda a, b: jnp.concatenate([a, b]), o1, o2
                    )
                else:
                    outs = None
                return state, (outs, jnp.stack([a1, a2]))

            state, (outs, accepts) = lax.scan(body, state, keys)
            if store:
                # (n_super, 2*interval, R, C, ...) -> (steps, R, C, ...)
                outs = jax.tree.map(
                    lambda x: x.reshape((-1,) + x.shape[2:]), outs
                )
            return state, outs, accepts

        return fused

    def _build_single(self):
        vstep = self._vstep
        swap_fns = self._swap_fns
        patch = self._patch_last

        @partial(jax.jit, static_argnames=("interval", "phase", "store"))
        def single(state, key, interval: int, phase: int, store: bool):
            state, outs = lax.scan(
                lambda s, o: (vstep(s)[0], None) if not store else vstep(s),
                state,
                None,
                length=interval,
            )
            state, accept = swap_fns[phase](state, key)
            outs = patch(outs, state) if store else None
            return state, outs, accept

        return single

    def _build_steps_only(self):
        vstep = self._vstep

        @partial(jax.jit, static_argnames=("n", "store"))
        def steps_only(state, n: int, store: bool):
            return lax.scan(
                lambda s, o: (vstep(s)[0], None) if not store else vstep(s),
                state,
                None,
                length=n,
            )

        return steps_only

    # ------------------------------------------------------------------ #
    # advancement
    # ------------------------------------------------------------------ #
    def _record_swaps(self, accept: np.ndarray, phase: int):
        """Accumulate lane-wise swap statistics for one swap phase."""
        _, partner = _even_odd_perm(self.n_rungs, phase)
        lanes = accept[0].size
        for i in range(self.n_rungs):
            j = partner[i]
            if j > i:
                self.attempted_swaps[i, j] += lanes
                self.successful_swaps[i, j] += accept[i].sum()

    def _store(self, outs, thin: int):
        if isinstance(outs, ens_kernel.EnsembleOutput):
            pos, logp = outs.walkers, outs.logps
        else:
            pos, logp = outs.theta, outs.logp
        # chunk lengths vary (2*interval*n_super vs single-cycle vs tail),
        # so thin against a running global step offset — a per-chunk [::thin]
        # would give an irregular stride across chunk boundaries
        offset = (-self._raw_steps) % thin
        self._raw_steps += pos.shape[0]
        pos, logp = pos[offset::thin], logp[offset::thin]
        if isinstance(pos, jax.Array) and not pos.is_fully_addressable:
            # multi-controller runs gather the global history per process
            self._history.append(self._gather_host(pos))
            self._prob_history.append(self._gather_host(logp))
            return
        pos, logp = jax.device_get((pos, logp))
        self._history.append(np.asarray(pos))
        self._prob_history.append(np.asarray(logp))

    def advance(self, n: int, swap_interval: int = 10, store: bool = True, thin: int = 1):
        """
        Advance all rungs exactly ``n`` steps, proposing even-odd replica
        swaps every ``swap_interval`` steps (any remainder runs as a
        swap-free tail, matching ``mcmc.ParallelTempering.advance``).
        Returns the stacked per-swap accept masks, shape
        (n_swaps, n_rungs, n_chains) — with a walker axis appended for the
        ensemble kind.
        """
        if n <= 0:
            raise ValueError("advance requires n > 0")
        cycles, rem = divmod(int(n), int(swap_interval))
        accepts = []

        remaining = cycles
        while remaining >= 2:
            n_super = min(1 << ((remaining // 2).bit_length() - 1), 256)
            self._swap_key, sub = jax.random.split(self._swap_key)
            keys = jax.random.split(sub, 2 * n_super).reshape(n_super, 2, -1)
            self._state, outs, acc = self._fused(
                self._state, keys, swap_interval, self._phase, store
            )
            acc = self._gather_host(acc)  # (n_super, 2, R, C[, W])
            for s in range(acc.shape[0]):
                self._record_swaps(acc[s, 0], self._phase)
                self._record_swaps(acc[s, 1], 1 - self._phase)
            accepts.append(acc.reshape((-1,) + acc.shape[2:]))
            if store:
                self._store(outs, thin)
            remaining -= 2 * n_super

        if remaining == 1:
            self._swap_key, sub = jax.random.split(self._swap_key)
            self._state, outs, acc = self._single(
                self._state, sub, swap_interval, self._phase, store
            )
            acc = self._gather_host(acc)
            self._record_swaps(acc, self._phase)
            accepts.append(acc[None])
            if store:
                self._store(outs, thin)
            self._phase ^= 1

        if rem > 0:
            self._state, outs = self._steps_only(self._state, rem, store)
            if store:
                self._store(outs, thin)
            else:
                jax.block_until_ready(jax.tree.leaves(self._state)[0])

        if accepts:
            return np.concatenate(accepts, axis=0)
        empty = (0, self.n_rungs, self.n_chains)
        if self.kind == "ensemble":
            empty = empty + (positions_of(self._state)[1].shape[-1],)
        return np.zeros(empty)

    def run_for(self, minutes=0, hours=0, days=0, swap_interval: int = 10,
                store: bool = True, thin: int = 1):
        """
        Advance all rungs for a chosen amount of wall-clock time
        (reference: parallel.py:283-326 — which self-calibrates how many
        cycles fit between status updates; here the calibration sizes the
        compiled chunk instead). Long drives should pass ``thin`` (or
        ``store=False``) — every stored step is steps x rungs x lanes of
        host memory.
        """
        run_time = ((days * 24.0 + hours) * 60.0 + minutes) * 60.0
        end_time = time() + run_time

        # warm the compiled cycle first (compilation costs seconds and
        # would wreck the calibration), then time a warm cycle
        self.advance(swap_interval, swap_interval, store=store, thin=thin)
        t1 = time()
        self.advance(swap_interval, swap_interval, store=store, thin=thin)
        t2 = time()

        # cycles per chunk for a status line roughly every 2 seconds,
        # power-of-two so the compiled-shape set stays bounded
        n = max(1, int(2.0 / max(t2 - t1, 1e-9)))
        n = 1 << (n.bit_length() - 1)

        while time() < end_time:
            chunk = min(n, 512)
            self.advance(chunk * swap_interval, swap_interval, store=store, thin=thin)
            if self.display_progress:
                seconds_remaining = max(end_time - time(), 0)
                m, s = divmod(seconds_remaining, 60)
                h, m = divmod(m, 60)
                sys.stdout.write(
                    f"\r  [ ShardedTempering - time remaining: "
                    f"{int(h)}:{int(m):02d}:{int(s):02d} ]    "
                )
                sys.stdout.flush()
        if self.display_progress:
            sys.stdout.write(
                "\r  [ ShardedTempering - run complete ]                  \n"
            )
            sys.stdout.flush()

    # ------------------------------------------------------------------ #
    # results & diagnostics
    # ------------------------------------------------------------------ #
    @property
    def theta(self) -> np.ndarray:
        """Positions: (n_rungs, n_chains, P), with a walker axis inserted
        before P for the ensemble kind."""
        return self._gather_host(positions_of(self._state)[0])

    @property
    def logp(self) -> np.ndarray:
        """Tempered log-probabilities, shape (n_rungs, n_chains[, W])."""
        return self._gather_host(positions_of(self._state)[1])

    def cold_chain_positions(self) -> np.ndarray:
        """Positions of the T=1 (first) rung."""
        return self.theta[0]

    def get_sample(self, rung: int = 0, burn: int = 0, thin: int = 1) -> np.ndarray:
        """
        Pooled stored samples of one rung, shape (n_kept * lanes, P).
        ``burn``/``thin`` apply to the stored step axis.
        """
        if not self._history:
            return np.empty([0, self.n_parameters])
        h = np.concatenate(self._history, axis=0)[burn::thin, rung]
        return h.reshape(-1, self.n_parameters)

    def get_probabilities(self, rung: int = 0, burn: int = 0, thin: int = 1) -> np.ndarray:
        """Pooled stored (tempered) log-probabilities of one rung."""
        if not self._prob_history:
            return np.empty([0])
        h = np.concatenate(self._prob_history, axis=0)[burn::thin, rung]
        return h.reshape(-1)

    def rhat(
        self, rung: int = 0, burn: int = 0, rank_normalized: bool = True
    ) -> np.ndarray:
        """
        Per-parameter split-R-hat across one rung's chain lanes — shape
        (n_parameters,); values near 1 (conventionally < 1.01) indicate
        the lanes have mixed into a common distribution. Defaults to the
        rank-normalized, folded estimator of Vehtari et al. (2021); for
        the ensemble kind every walker counts as a replicate chain. The
        natural convergence check for the cold rung of a tempered run —
        a between-chain statistic the reference's process-per-rung
        design has no analogue of (its diagnostics are swap rates only:
        reference inference/mcmc/parallel.py:328-362).
        """
        from ..utils.diagnostics import rank_normalized_rhat, split_rhat

        if not self._history:
            raise ValueError(
                "[ ShardedTempering error ] no stored history - advance "
                "with store=True before requesting rhat."
            )
        h = np.concatenate(self._history, axis=0)[burn:, rung]
        if h.ndim == 4:  # ensemble kind: (steps, C, W, P) -> lanes merge
            h = h.reshape(h.shape[0], -1, h.shape[-1])
        # (steps, C, P) -> (P, C, steps)
        series = jnp.transpose(jnp.asarray(h), (2, 1, 0))
        estimator = rank_normalized_rhat if rank_normalized else split_rhat
        return np.asarray(estimator(series))

    def swap_rate_matrix(self) -> np.ndarray:
        """Per-rung-pair swap acceptance rates (upper-triangular)."""
        return self.successful_swaps / self.attempted_swaps.clip(min=1)

    def swap_diagnostics(self, show: bool = True):
        """Plot acceptance rates of position swaps between the rungs
        (reference: parallel.py:328-362)."""
        import matplotlib.pyplot as plt
        from ..plotting import transition_matrix_plot

        rate_matrix = self.swap_rate_matrix()
        total_swaps = self.successful_swaps.sum(axis=0) + self.successful_swaps.sum(axis=1)

        fig = plt.figure(figsize=(10, 5))
        ax1 = fig.add_subplot(121)
        transition_matrix_plot(
            axis=ax1,
            matrix=rate_matrix,
            exclude_diagonal=True,
            upper_triangular=True,
        )
        ax1.set_xlabel("rung number")
        ax1.set_ylabel("rung number")
        ax1.set_title("acceptance rate of rung position swaps")

        ax2 = fig.add_subplot(122)
        ax2.bar(range(1, self.n_rungs + 1), total_swaps)
        ax2.set_ylim([0, None])
        ax2.set_xlabel("rung number")
        ax2.set_ylabel("total successful position swaps")

        plt.tight_layout()
        if show:
            plt.show()
        return fig

    def update_directions(self, last: int = None):
        """
        Re-estimate PCA sweep directions per (rung, lane) from the stored
        history: one batched host eigendecomposition, then a single
        host-to-device transfer (pca kind only; requires stored history).
        """
        if self.kind != "pca":
            raise ValueError(
                "[ ShardedTempering error ] update_directions is only "
                "available for kind='pca'."
            )
        if not self._history:
            return self
        h = np.concatenate(self._history, axis=0)  # (steps, R, C, P)
        if last is not None:
            h = h[-last:]
        if h.shape[0] < max(2 * self.n_parameters, 3):
            return self
        centred = h - h.mean(axis=0, keepdims=True)
        covs = np.einsum("srcp,srcq->rcpq", centred, centred) / (
            h.shape[0] - 1
        )
        _, vecs = np.linalg.eigh(covs)
        state = self._state._replace(
            directions=jnp.asarray(vecs, positions_of(self._state)[0].dtype)
        )
        self._state = self._shard(state)
        return self

    # ------------------------------------------------------------------ #
    # checkpoint / resume for long multi-chip runs
    # ------------------------------------------------------------------ #
    @staticmethod
    def _gather_host(v):
        """Host copy of a (possibly multi-controller) device array. Under
        ``jax.distributed`` the sharded state is not fully addressable
        from any single process, so ``np.asarray`` would fail — gather
        the global value across processes instead."""
        if isinstance(v, jax.Array) and not v.is_fully_addressable:
            from jax.experimental import multihost_utils

            return np.asarray(
                multihost_utils.process_allgather(v, tiled=True)
            )
        return np.asarray(v)

    def save(self, filename: str):
        """Checkpoint the sharded replica-exchange state (gathered to the
        host as flat arrays; multi-controller safe — every process gathers
        the full global state and may write its own copy)."""
        leaves, _ = jax.tree.flatten(self._state)
        items = {f"leaf_{i}": self._gather_host(v) for i, v in enumerate(leaves)}
        items["temperatures"] = self.temperatures
        items["n_chains"] = self.n_chains
        items["kind"] = self.kind
        items["phase"] = self._phase
        items["attempted_swaps"] = self.attempted_swaps
        items["successful_swaps"] = self.successful_swaps
        np.savez(filename, **items)

    def restore(self, filename: str):
        """Restore a checkpoint saved by ``save`` into this instance
        (same mesh / kind / temperatures / chain count), re-applying the
        rung x chain shardings."""
        D = np.load(filename)
        # older checkpoints (pre round-2 full-surface rewrite) stored a
        # 'swap_counter' instead of 'kind'/'phase' and carried no swap-stat
        # matrices — fall back rather than stranding a resumable run
        ck_kind = str(D["kind"]) if "kind" in D else self.kind
        if "phase" in D:
            ck_phase = int(D["phase"])
        elif "swap_counter" in D:
            ck_phase = int(D["swap_counter"]) % 2
        else:
            ck_phase = 0
        if (
            int(D["n_chains"]) != self.n_chains
            or ck_kind != self.kind
            or not np.allclose(D["temperatures"], self.temperatures)
        ):
            raise ValueError(
                "[ ShardedTempering error ] checkpoint configuration does "
                "not match this instance."
            )
        leaves, treedef = jax.tree.flatten(self._state)
        n_saved = sum(1 for k in D.files if k.startswith("leaf_"))
        if n_saved != len(leaves):
            raise ValueError(
                f"[ ShardedTempering error ] checkpoint stores {n_saved} "
                f"state leaves but the current '{self.kind}' state has "
                f"{len(leaves)} — the checkpoint predates a kernel "
                f"state-layout change (e.g. the NUTS state gaining its "
                f"cached gradient); re-create it from the source run."
            )
        new_leaves = [
            jnp.asarray(D[f"leaf_{i}"], v.dtype) for i, v in enumerate(leaves)
        ]
        self._state = self._shard(jax.tree.unflatten(treedef, new_leaves))
        self._phase = ck_phase
        if "attempted_swaps" in D:
            self.attempted_swaps = np.asarray(D["attempted_swaps"])
            self.successful_swaps = np.asarray(D["successful_swaps"])
        else:
            self.attempted_swaps = np.identity(self.n_rungs)
            self.successful_swaps = np.zeros((self.n_rungs, self.n_rungs))
        return self
