"""Multi-host (DCN) tests: two real ``jax.distributed`` processes.

The reference's parallel layer actually runs multi-process
(reference: inference/mcmc/parallel.py:106-136); these tests hold the
rebuild's DCN equivalent (``parallel/multihost.py``) to the same standard:
two CPU multi-controller processes join over a localhost coordinator,
form one 8-device system, and run (1) a cross-process psum + sharded
``ChainArray`` advance, (2) a ``ShardedTempering`` program whose ppermute
swap phases cross the process boundary, and (3) a cross-process
checkpoint/restore round-trip of the sharded tempering state — all
executed for real, not just imported. The worker pair runs once per
module (it costs ~1 min); the tests assert on disjoint aspects of its
reported results.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def multihost_results():
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count

    procs = [
        subprocess.Popen(
            [
                sys.executable,
                os.path.join(HERE, "_multihost_worker.py"),
                coordinator,
                "2",
                str(i),
            ],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
        assert p.returncode == 0, f"worker failed:\n{out}"

    results = []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("RESULT ")]
        assert lines, f"no RESULT line in worker output:\n{out}"
        results.append(json.loads(lines[0][len("RESULT "):]))
    return results


pytestmark = pytest.mark.slow


def test_two_process_system_and_collectives(multihost_results):
    """Initialization forms one 8-device system; a psum crosses the
    process boundary; a mesh-sharded ChainArray advances."""
    results = multihost_results
    for i, r in enumerate(results):
        assert r["n_processes"] == 2
        assert r["process_id"] == i
        assert r["local_devices"] == 4
        assert r["global_devices"] == 8
        # psum over all 8 global devices of (axis_index + 1): 1+2+...+8
        assert r["psum"] == pytest.approx(36.0)
        assert np.isfinite(r["mean_logp"])
        assert r["mean_move"] > 0.0  # the sharded chains actually moved
        # global_tempering_mesh keeps each rung ladder within one process
        # (4 rungs fit in a 4-device host), so swaps stay within a host
        assert r["tempering_col_procs"] == [1, 1]

    # both controllers computed identical global statistics
    assert results[0]["mean_logp"] == pytest.approx(results[1]["mean_logp"])
    assert results[0]["mean_move"] == pytest.approx(results[1]["mean_move"])


def test_sharded_tempering_advances_across_processes(multihost_results):
    """ShardedTempering spans both processes (4 rungs x 2 chain shards
    over 8 global devices) and its ppermute swaps accept at a healthy
    rate — the multi-controller equivalent of the reference's
    pipe-synchronised swap step (reference: parallel.py:190-231)."""
    results = multihost_results
    for r in results:
        assert r["temper_logp_finite"]
        assert 0.05 < r["temper_swap_rate"] < 1.0
    # both controllers hold the same gathered global positions
    assert results[0]["temper_theta_mean"] == pytest.approx(
        results[1]["temper_theta_mean"]
    )


def test_sharded_tempering_checkpoint_restore_across_processes(
    multihost_results,
):
    """save() gathers the non-fully-addressable sharded state across
    processes; restore() into a fresh instance on the same global mesh
    reproduces the source positions exactly and keeps advancing."""
    for r in multihost_results:
        assert r["restore_exact"]
        assert r["restored_moved"]
