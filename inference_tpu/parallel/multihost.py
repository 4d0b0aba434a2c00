"""Multi-host scale-out helpers.

The reference's only cross-process mechanism is ``multiprocessing`` pipes
on one machine (reference: inference/mcmc/parallel.py:33-136). The rebuild
scales past a single host with jax's multi-controller runtime: every host
runs the same program, ``jax.distributed.initialize`` wires the hosts into
one system, and a global ``Mesh`` over ``jax.devices()`` (all devices on
all hosts) makes the existing ``ChainArray`` / ``ShardedTempering``
programs span every host — XLA hands collectives to NCCL, over NVLink
between the GPUs of one host and over the network between hosts, with no
user-visible changes.

Design guidance: keep communication-heavy axes (tempering 'rungs'
ppermutes) within a host and put the embarrassingly-parallel 'chains'
axis across hosts — independent chains never communicate, so the
network's bandwidth is irrelevant to them.
"""

import numpy as np
import jax
from jax.sharding import Mesh


def initialize_multihost(
    coordinator_address: str = None,
    num_processes: int = None,
    process_id: int = None,
):
    """
    Join this process into a multi-host jax system: pass
    ``coordinator_address`` ("host:port" of process 0), ``num_processes``
    and this host's ``process_id`` (on clusters whose environment JAX
    recognises, they may be left out).

    Call once, before any jax computation, on every host.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    jax.distributed.initialize(**kwargs)
    return {
        "process_id": jax.process_index(),
        "n_processes": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }


def global_chain_mesh(axis_name: str = "chains") -> Mesh:
    """A 1D mesh over every device on every host: shard chain batches
    across the whole system (chains are independent, so the cross-host
    axis costs no bandwidth during sampling)."""
    return Mesh(np.array(jax.devices()), (axis_name,))


def global_tempering_mesh(n_rungs: int) -> Mesh:
    """
    A ('rungs', 'chains') mesh over every device on every host, with the
    rung axis laid out along contiguous devices (within a host where
    possible) so swap ppermutes stay on NVLink rather than the network.
    """
    devices = jax.devices()
    n = len(devices)
    if n % n_rungs != 0:
        raise ValueError(
            f"n_rungs ({n_rungs}) must divide the global device count ({n})"
        )
    # jax.devices() orders devices host-major: reshaping chains-major puts
    # consecutive rungs on consecutive devices of the same host
    grid = np.array(devices).reshape(n // n_rungs, n_rungs).T
    return Mesh(grid, ("rungs", "chains"))
