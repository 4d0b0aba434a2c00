"""Vectorised arrays of independent chains.

The device-resident replacement for the reference's process-pool data
parallelism (reference: inference/mcmc/parallel.py:15-30, which pickles
whole chain objects to a multiprocessing.Pool): a single sampler step is
``vmap``-ed over a leading chain axis, the whole batch advances inside one
``lax.scan``, and the batch is optionally sharded over a device mesh with a
``NamedSharding`` — thousands of chains per device, scaling over the
device interconnect with no host involvement in the sampling loop.
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..utils import make_key, default_float, as_device_logp
from ..mcmc._kernels import ensemble as ens_kernel
from ..mcmc._kernels.hmc import run_steps
from ._kinds import build_kind


def _warmup_window_sizes(n_steps: int, n_windows: int) -> np.ndarray:
    """Expanding warmup windows (1x, 1x, 2x, 4x, ... of the base), so late
    windows — where the chains have reached the typical set — dominate the
    final mass estimate. Always sums to exactly ``n_steps`` with every
    window >= 2 (reachable because ``warmup`` validates
    ``n_steps >= 2 * n_windows``): a rounding deficit goes to the final
    window, a clamping excess is taken from the latest windows that can
    still afford it."""
    weights = np.array(
        [1.0] + [float(1 << max(0, w - 1)) for w in range(1, n_windows)]
    )
    sizes = np.maximum((n_steps * weights / weights.sum()).astype(int), 2)
    excess = int(sizes.sum()) - n_steps
    i = len(sizes) - 1
    while excess > 0:
        take = min(excess, int(sizes[i]) - 2)
        sizes[i] -= take
        excess -= take
        i -= 1
    if excess < 0:
        sizes[-1] -= excess
    return sizes


class ChainArray:
    """
    A batch of ``n_chains`` independent sampler chains advanced as one
    compiled program.

    :param kind: sampler family — "hmc", "nuts" (No-U-Turn trajectories,
        beyond the reference), "gibbs", "metropolis", "pca"
        (PCA-directed Gibbs sweeps; call ``update_directions()`` between
        advances to re-estimate each chain's principal directions from its
        own history — a batched host eigendecomposition) or "ensemble"
        (each chain is an independent stretch-move ensemble; ``starts`` has
        shape (n_chains, n_walkers, n_parameters)).
    :param posterior: traceable log-probability callable.
    :param starts: starting positions, shape (n_chains, n_parameters) —
        or (n_chains, n_walkers, n_parameters) for the ensemble kind.
    :param widths: initial proposal widths (gibbs/metropolis families).
    :param epsilon: initial leapfrog step size (hmc).
    :param steps: nominal leapfrog steps per proposal (hmc).
    :param max_depth: maximum trajectory doublings per transition (nuts).
    :param inverse_mass: scalar, (P,) diagonal, or full (P, P) matrix
        inverse mass (hmc; reference: hmc/mass.py:9-117).
    :param non_negative: bool or (P,) bools — parameters whose proposals
        are folded non-negative (gibbs/metropolis;
        reference: gibbs.py:97-104).
    :param boundaries: optional (lower, upper) reflecting proposal
        boundaries (gibbs/metropolis; reference: gibbs.py:106-122).
    :param bounds: optional ``utils.Bounds`` for the hmc (bounded
        leapfrog) and ensemble (reflected stretch moves) kinds.
    :param alpha: stretch-move scale parameter (ensemble kind).
    :param retry: repeat-until-accept proposals (the reference semantics)
        when True; textbook duplicate-on-reject MH when False — the latter
        avoids all retry-loop waste under vmap (a retry loop reruns every
        chain lane until the slowest lane accepts) and is the recommended
        setting for large chain batches.
    :param mesh: optional ``jax.sharding.Mesh`` whose ``axis_name`` axis the
        chain batch is sharded over.
    :param axis_name: mesh axis to shard over (default "chains").
    :param seed: optional integer PRNG seed.
    """

    def __init__(
        self,
        kind: str,
        posterior,
        starts,
        *,
        widths=None,
        epsilon: float = 0.1,
        steps: int = 50,
        inverse_mass=None,
        non_negative=None,
        boundaries=None,
        bounds=None,
        alpha: float = 2.0,
        max_depth: int = 10,
        retry: bool = True,
        mesh=None,
        axis_name: str = "chains",
        seed=None,
    ):
        starts = np.asarray(starts, dtype=float)
        if kind == "ensemble":
            if starts.ndim != 3:
                raise ValueError(
                    "the ensemble kind requires starts of shape "
                    "(n_chains, n_walkers, n_parameters)"
                )
            self.n_chains, self.n_walkers, self.n_parameters = starts.shape
        else:
            starts = np.atleast_2d(starts)
            self.n_chains, self.n_parameters = starts.shape
            self.n_walkers = None
        self.kind = kind
        self.mesh = mesh
        self.axis_name = axis_name

        dtype = default_float()
        self._logp = as_device_logp(
            posterior, starts[0, 0] if kind == "ensemble" else starts[0]
        )
        key = make_key(seed)
        keys = jax.random.split(key, self.n_chains)
        starts_dev = jnp.asarray(starts, dtype)

        # kept so warmup()/set_inverse_mass() can rebuild the kernel with
        # a re-estimated mass while preserving the live state
        self._build_kwargs = dict(
            # widths may be per-chain (n_chains, P): the real values are
            # written into the state after init (below); build_kind only
            # needs a placeholder of per-chain shape-free form
            widths=1.0 if kind in ("gibbs", "metropolis", "pca") else widths,
            epsilon=epsilon,
            steps=steps,
            inverse_mass=inverse_mass,
            non_negative=non_negative,
            boundaries=boundaries,
            bounds=bounds,
            alpha=alpha,
            n_walkers=self.n_walkers,
            retry=retry,
            max_depth=max_depth,
        )
        init, step = build_kind(
            kind, self._logp, self.n_parameters, dtype, **self._build_kwargs
        )

        if kind == "ensemble":
            logp0 = jax.vmap(jax.vmap(self._logp))(starts_dev)
        else:
            logp0 = jax.vmap(self._logp)(starts_dev)
        state = jax.vmap(init, in_axes=(0, 0, 0, None))(
            starts_dev, logp0, keys, jnp.asarray(1.0, dtype)
        )

        if kind in ("gibbs", "metropolis", "pca"):
            # per-chain initial widths: 5% of each chain's own start point
            # when unspecified (reference: gibbs.py:258-259)
            if widths is None:
                per_chain = np.where(starts != 0, np.abs(starts) * 0.05, 1.0)
            else:
                per_chain = np.broadcast_to(
                    np.asarray(widths, dtype=float), starts.shape
                )
            state = state._replace(
                widths=state.widths._replace(
                    value=jnp.asarray(per_chain, dtype)
                )
            )

        self._step = jax.vmap(step)
        self._state = state
        if mesh is not None:
            self._state = jax.tree.map(
                lambda x: jax.device_put(
                    x, NamedSharding(mesh, P(axis_name, *([None] * (x.ndim - 1))))
                ),
                self._state,
            )

        self._history = []
        self._prob_history = []

    def advance(self, n: int, store: bool = True, thin: int = 1):
        """
        Advance every chain ``n`` steps in one compiled scan. With
        ``store=False`` only the final state is kept (maximum throughput);
        otherwise every ``thin``-th step's positions are appended to the
        host history.
        """
        state, outs = run_steps(self._step, self._state, n, store)
        self._state = state
        if store:
            if self.kind == "ensemble":
                pos, logp = outs.walkers, outs.logps
            else:
                pos, logp = outs.theta, outs.logp
            pos, logp = jax.device_get((pos[::thin], logp[::thin]))
            self._history.append(np.asarray(pos))  # (n/thin, K[, W], P)
            self._prob_history.append(np.asarray(logp))
        else:
            # no outputs were materialised at all (the scan emits None)
            jax.block_until_ready(jax.tree.leaves(state)[0])
        return self

    def set_inverse_mass(self, inverse_mass):
        """
        Rebuild the transition kernel with a new inverse mass (scalar,
        (P,) diagonal, or (P, P) matrix), preserving the live chain state
        — positions, log-probabilities, cached gradients and step-size
        adaptation are all mass-independent, so only the kernel closure
        changes (one recompile on the next ``advance``).
        """
        if self.kind not in ("hmc", "nuts"):
            raise ValueError(
                "[ ChainArray error ] set_inverse_mass applies to the "
                "'hmc' and 'nuts' kinds only."
            )
        self._build_kwargs["inverse_mass"] = inverse_mass
        _, step = build_kind(
            self.kind,
            self._logp,
            self.n_parameters,
            default_float(),
            **self._build_kwargs,
        )
        self._step = jax.vmap(step)
        return self

    def warmup(
        self,
        n_steps: int = 500,
        n_windows: int = 4,
        store: bool = False,
    ):
        """
        Windowed diagonal mass adaptation for the hmc/nuts kinds (the
        Stan-style warmup the reference's mass matrices are set from
        chain variance by hand, reference: hmc/__init__.py:202-209):
        advance in ``n_windows`` expanding windows; after each, set the
        inverse mass to the per-parameter posterior variance pooled over
        all chains and the window's steps — on badly-scaled targets this
        raises post-warmup ESS/step by orders of magnitude. Step-size
        adaptation keeps running throughout and re-adapts to each new
        mass. Warmup samples are discarded (``store=False``) by default.
        """
        if self.kind not in ("hmc", "nuts"):
            raise ValueError(
                "[ ChainArray error ] warmup applies to the 'hmc' and "
                "'nuts' kinds only."
            )
        if n_windows < 1 or n_steps < 2 * n_windows:
            raise ValueError(
                "[ ChainArray error ] warmup needs n_windows >= 1 and "
                "n_steps >= 2 * n_windows."
            )
        sizes = _warmup_window_sizes(n_steps, n_windows)
        mark = len(self._history)
        for size in sizes:
            self.advance(int(size), store=True)
            h = np.concatenate(self._history[mark:], axis=0)
            # pooled variance across chains and window steps
            flat = h.reshape(-1, self.n_parameters)
            var = flat.var(axis=0)
            floor = 1e-12 * max(float(var.max()), 1e-30)
            self.set_inverse_mass(np.maximum(var, floor))
        if not store:
            del self._history[mark:]
            del self._prob_history[mark:]
        return self

    def update_directions(self, last: int = None):
        """
        Re-estimate each chain's PCA sweep directions from its own stored
        history (optionally only the ``last`` steps): one batched
        ``np.linalg.eigh`` over the per-chain sample covariances, then a
        single host-to-device transfer of the direction stack (the
        directions live in the state, so the compiled program is reused —
        reference: pca.py:96-134 does this per chain on the host).
        """
        if self.kind != "pca":
            raise ValueError(
                "[ ChainArray error ] update_directions is only available "
                "for kind='pca'."
            )
        if not self._history:
            return self
        h = np.concatenate(self._history, axis=0)  # (steps, K, P)
        if last is not None:
            h = h[-last:]
        if h.shape[0] < max(2 * self.n_parameters, 3):
            return self  # not enough samples for a stable covariance
        centred = h - h.mean(axis=0, keepdims=True)
        covs = np.einsum("skp,skq->kpq", centred, centred) / (h.shape[0] - 1)
        _, vecs = np.linalg.eigh(covs)  # batched; columns are directions
        self._state = self._state._replace(
            directions=jnp.asarray(vecs, self._state.theta.dtype)
        )
        return self

    def effective_sample_size(self, burn: int = 0) -> np.ndarray:
        """
        Per-chain, per-parameter effective sample sizes — shape
        (n_chains, n_parameters), with a walker axis inserted for the
        ensemble kind: (n_chains, n_walkers, n_parameters). Computed as
        one batched device FFT autocorrelation (same estimator as
        ``inference_tpu.utils.effective_sample_size``, reference:
        mcmc/utilities.py:83-95 — which handles one series at a time).
        """
        from ..utils.ess import effective_sample_size_batched

        if not self._history:
            raise ValueError(
                "[ ChainArray error ] no stored history - advance with "
                "store=True before requesting effective sample sizes."
            )
        h = np.concatenate(self._history, axis=0)[burn:]  # (steps, K[, W], P)
        series = jnp.moveaxis(jnp.asarray(h), 0, -1)  # (K[, W], P, steps)
        return np.asarray(effective_sample_size_batched(series))

    def rhat(self, burn: int = 0, rank_normalized: bool = True) -> np.ndarray:
        """
        Per-parameter split-R-hat across the chain batch — shape
        (n_parameters,). Chains (and walkers, for the ensemble kind) are
        the replicate axis; values near 1 (conventionally < 1.01)
        indicate the batch has mixed into a common distribution. By
        default the rank-normalized, folded variant of Vehtari et al.
        (2021) is used (robust to heavy tails, sensitive to scale
        differences); ``rank_normalized=False`` gives the classic
        Gelman-Rubin split statistic. One batched device program
        regardless of chain count — a between-chain diagnostic the
        reference cannot offer (it diagnoses single chains only:
        reference inference/mcmc/utilities.py:83-95, gibbs.py:577-592).
        """
        from ..utils.diagnostics import rank_normalized_rhat, split_rhat

        if not self._history:
            raise ValueError(
                "[ ChainArray error ] no stored history - advance with "
                "store=True before requesting rhat."
            )
        h = np.concatenate(self._history, axis=0)[burn:]  # (steps, K[, W], P)
        if h.ndim == 4:  # ensemble kind: every walker is a replicate chain
            h = h.reshape(h.shape[0], -1, h.shape[-1])
        # (steps, K, P) -> (P, K, steps)
        series = jnp.transpose(jnp.asarray(h), (2, 1, 0))
        estimator = rank_normalized_rhat if rank_normalized else split_rhat
        return np.asarray(estimator(series))

    @property
    def theta(self) -> np.ndarray:
        """Current positions, shape (n_chains[, n_walkers], n_parameters)."""
        from ._kinds import positions_of

        return np.asarray(positions_of(self._state)[0])

    @property
    def logp(self) -> np.ndarray:
        """Current log-probabilities, shape (n_chains[, n_walkers])."""
        from ._kinds import positions_of

        return np.asarray(positions_of(self._state)[1])

    def get_sample(self, burn: int = 0, thin: int = 1) -> np.ndarray:
        """
        Pooled samples from all chains, shape (n_kept * K, P). ``burn`` and
        ``thin`` apply to the **step** axis (each step contributes K
        samples).
        """
        if not self._history:
            return np.empty([0, self.n_parameters])
        h = np.concatenate(self._history, axis=0)[burn::thin]
        return h.reshape(-1, self.n_parameters)

    def get_probabilities(self, burn: int = 0, thin: int = 1) -> np.ndarray:
        if not self._prob_history:
            return np.empty([0])
        h = np.concatenate(self._prob_history, axis=0)[burn::thin]
        return h.reshape(-1)

    # ------------------------------------------------------------------ #
    # checkpoint / resume (device state as flat .npz arrays)
    # ------------------------------------------------------------------ #
    def save(self, filename: str):
        """Checkpoint the full device state (positions, log-probabilities,
        adaptation state, PRNG keys) so a long run can restart exactly."""
        leaves, treedef = jax.tree.flatten(self._state)
        items = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)}
        items["kind"] = self.kind
        items["n_chains"] = self.n_chains
        items["n_parameters"] = self.n_parameters
        np.savez(filename, **items)

    def restore(self, filename: str):
        """Restore a device state saved by ``save`` into this ChainArray
        (which must have been constructed with the same configuration)."""
        D = np.load(filename)
        if str(D["kind"]) != self.kind or int(D["n_chains"]) != self.n_chains:
            raise ValueError(
                "[ ChainArray error ] checkpoint configuration does not match "
                "this ChainArray (kind / n_chains differ)."
            )
        leaves, treedef = jax.tree.flatten(self._state)
        n_saved = sum(1 for k in D.files if k.startswith("leaf_"))
        if n_saved != len(leaves):
            raise ValueError(
                f"[ ChainArray error ] checkpoint stores {n_saved} state "
                f"leaves but the current '{self.kind}' state has "
                f"{len(leaves)} — the checkpoint predates a kernel "
                f"state-layout change (e.g. the NUTS state gaining its "
                f"cached gradient); re-create it from the source run."
            )
        new_leaves = [
            jnp.asarray(D[f"leaf_{i}"], v.dtype) for i, v in enumerate(leaves)
        ]
        self._state = jax.tree.unflatten(treedef, new_leaves)
        if self.mesh is not None:
            self._state = jax.tree.map(
                lambda x: jax.device_put(
                    x,
                    NamedSharding(
                        self.mesh,
                        P(self.axis_name, *([None] * (x.ndim - 1))),
                    ),
                ),
                self._state,
            )
        return self
