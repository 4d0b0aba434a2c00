"""The chip smoke script's host-driven and multi-device phases at tiny
sizes on the CPU, every phase is covered by these tests or by
test_chip_smoke.py, and the entry points refuse to measure without a
GPU."""

import os
import subprocess
import sys

import pytest

from test_chip_smoke import DEVICE_PHASES, ROOT, chip_smoke, run_tiny

PATH_PHASES = ["bo", "tempering", "host_callback"] + [
    n for n, _, _ in chip_smoke.FOUR_CARD_PHASES
]


def test_every_phase_is_tested():
    names = [n for n, _, _ in chip_smoke.PHASES + chip_smoke.FOUR_CARD_PHASES]
    assert sorted(names) == sorted(DEVICE_PHASES + PATH_PHASES)


@pytest.mark.parametrize("name", PATH_PHASES)
def test_path_phase_passes_at_tiny_size(name):
    run_tiny(name)


def _run_script(args, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra_env or {})
    return subprocess.run(
        [sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize(
    "script",
    [["chip_smoke.py"], ["chip_smoke.py", "--four-cards"], ["bench.py"],
     ["benchmarks/run_all.py"]],
)
def test_entry_point_refuses_cpu(script):
    """With no GPU the entry points exit non-zero, say why, and print no
    result line."""
    out = _run_script(script)
    assert out.returncode != 0
    assert "needs an NVIDIA GPU" in out.stderr
    assert '"ok"' not in out.stdout and "samples" not in out.stdout
