"""The chip smoke script's device phases and checks at tiny sizes on the
CPU."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


# the host-driven and multi-device phases run in test_chip_smoke_paths.py,
# so the two halves can go to different test workers
DEVICE_PHASES = ["hmc", "chain_kinds", "hmc_step", "gp_lml", "df64", "assembly"]


def run_tiny(name):
    phases = {
        n: f for n, f, _ in chip_smoke.PHASES + chip_smoke.FOUR_CARD_PHASES
    }
    lines = phases[name](chip_smoke.TINY, chip_smoke.CompileClock())
    assert lines and all(isinstance(line, str) for line in lines)


@pytest.mark.parametrize("name", DEVICE_PHASES)
def test_phase_passes_at_tiny_size(name):
    run_tiny(name)


def test_check_moments_rejects_wrong_covariance():
    import numpy as np

    cov = chip_smoke.correlated_gaussian()
    draws = chip_smoke.target_draws(cov, (4096,), seed=0)
    chip_smoke.check_moments(draws, cov, "exact")
    with pytest.raises(chip_smoke.PhaseFailure):
        chip_smoke.check_moments(1.2 * draws, cov, "scaled")
    with pytest.raises(chip_smoke.PhaseFailure):
        chip_smoke.check_moments(draws + 0.1, cov, "shifted")
    with pytest.raises(chip_smoke.PhaseFailure):
        chip_smoke.check_moments(np.full_like(draws, np.nan), cov, "nan")


def test_run_phases_counts_a_failed_phase():
    def bad(sizes, clock):
        chip_smoke.check(False, "wrong answer")

    def good(sizes, clock):
        return ["fine"]

    log = []
    failed = chip_smoke.run_phases(
        [("good", good, False), ("bad", bad, False)],
        chip_smoke.TINY, chip_smoke.CompileClock(), log=log.append,
    )
    assert failed == ["bad"]
    assert any("wrong answer" in line for line in log)


