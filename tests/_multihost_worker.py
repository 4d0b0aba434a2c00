"""Worker process for the multi-host smoke test (see test_multihost.py).

Run as:  python _multihost_worker.py <coordinator> <n_procs> <proc_id>

Each worker is its own jax "host" with 4 forced CPU devices; together the
processes form one 8-device multi-controller system over a localhost
coordinator — the CI-sized stand-in for a real multi-host cluster.
Prints one JSON line of results for the parent to assert on.
"""

import json
import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4"
)

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P


def main():
    coordinator, n_procs, proc_id = (
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from inference_tpu.parallel.multihost import (
        initialize_multihost,
        global_chain_mesh,
        global_tempering_mesh,
    )

    info = initialize_multihost(
        coordinator_address=coordinator,
        num_processes=n_procs,
        process_id=proc_id,
    )

    mesh = global_chain_mesh()
    # cross-process collective: every device contributes its index + 1;
    # the psum must see all 8 global devices (sum = 36)
    @jax.jit
    def collective_sum():
        def f(x):
            return jax.lax.psum(
                x * (jax.lax.axis_index("chains") + 1.0), "chains"
            )

        ones = jnp.ones((mesh.size, 1))
        return shard_map(
            f, mesh=mesh, in_specs=P("chains", None), out_specs=P(None, None)
        )(ones)

    psum_result = float(np.asarray(collective_sum())[0, 0])

    # a ChainArray advanced over the global mesh: 8 chains, one per device
    from inference_tpu.parallel import ChainArray
    from inference_tpu.parallel._kinds import positions_of

    starts = np.tile(np.array([1.0, -0.5]), (8, 1))
    ca = ChainArray(
        "gibbs",
        lambda t: -0.5 * jnp.sum(jnp.asarray(t) ** 2),
        starts,
        mesh=mesh,
        seed=7,
        retry=False,
    )
    ca.advance(64, store=False)

    @jax.jit
    def summary(state):
        pos, logp = positions_of(state)
        return jnp.mean(logp), jnp.mean(jnp.abs(pos - jnp.asarray(starts)))

    mean_logp, mean_move = map(float, summary(ca._state))

    # rung-contiguity of the global tempering mesh: each column (chains
    # lane) should hold rungs from ONE process where possible
    tmesh = global_tempering_mesh(4)
    col_procs = [
        len({d.process_index for d in tmesh.devices[:, c]})
        for c in range(tmesh.devices.shape[1])
    ]

    # a ShardedTempering program spanning BOTH processes: 4 rungs x 2
    # chain shards over the 8 global devices; the even/odd ppermute swap
    # phases cross the process boundary (the DCN stand-in), and the
    # advance runs as one multi-controller SPMD program
    import tempfile
    from inference_tpu.parallel import ShardedTempering

    st = ShardedTempering(
        posterior=lambda t: -0.5 * jnp.sum(jnp.asarray(t) ** 2),
        start=np.array([1.0, -1.0]),
        temperatures=np.geomspace(1.0, 20.0, 4),
        n_chains=4,
        mesh=tmesh,
        steps=5,
        epsilon=0.25,
        seed=3,
    )
    accepted = st.advance(20, swap_interval=5)
    temper_swap_rate = float(np.asarray(accepted).mean())
    temper_theta = st.theta  # gathered global state (all processes equal)
    temper_logp_finite = bool(np.isfinite(st.logp).all())

    # cross-process checkpoint/restore round-trip: gather-save the global
    # state, restore into a FRESH instance on the same global mesh, and
    # verify the restored state reproduces the source positions exactly
    ckpt = os.path.join(
        tempfile.gettempdir(), f"mh_tempering_{proc_id}.npz"
    )
    st.save(ckpt)
    st2 = ShardedTempering(
        posterior=lambda t: -0.5 * jnp.sum(jnp.asarray(t) ** 2),
        start=np.array([1.0, -1.0]),
        temperatures=np.geomspace(1.0, 20.0, 4),
        n_chains=4,
        mesh=tmesh,
        steps=5,
        epsilon=0.25,
        seed=99,
    )
    st2.restore(ckpt)
    restore_exact = bool(np.array_equal(st2.theta, temper_theta))
    st2.advance(10, swap_interval=5)  # the restored run keeps advancing
    restored_moved = bool(np.isfinite(st2.logp).all())
    os.remove(ckpt)

    print(
        "RESULT "
        + json.dumps(
            {
                **info,
                "psum": psum_result,
                "mean_logp": mean_logp,
                "mean_move": mean_move,
                "tempering_col_procs": col_procs,
                "temper_swap_rate": temper_swap_rate,
                "temper_theta_mean": float(np.abs(temper_theta).mean()),
                "temper_logp_finite": temper_logp_finite,
                "restore_exact": restore_exact,
                "restored_moved": restored_moved,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
