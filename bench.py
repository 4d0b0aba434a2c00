"""Headline benchmark: batched HMC throughput on a 10-dim correlated
Gaussian (BASELINE.json north star), measured as MCMC samples/sec/device
on an NVIDIA GPU (it exits non-zero without one).

``vs_baseline`` compares against the single-core reference implementation
(C-bowman/inference-tools) running the identical posterior with an analytic
gradient, measured fresh on this machine each run when that package is
importable (the reference publishes no numbers of its own — see
BASELINE.md).

Prints exactly one JSON line, naming the device and the card.
"""

import json
import sys
import time
import types

import numpy as np

N_DIM = 10
HMC_STEPS = 50  # leapfrog steps per proposal (reference default)
REF_TIME_BUDGET = 3.0  # seconds of reference sampling to measure
CHAIN_SWEEP = (1024, 4096, 16384, 65536, 131072)  # sweep to saturation
WORK_PER_TIER = 1 << 22  # ~4.2M chain-transitions timed per tier


def make_cov():
    rng = np.random.default_rng(42)
    A = rng.normal(size=(N_DIM, N_DIM)) / np.sqrt(N_DIM)
    return A @ A.T + np.eye(N_DIM)


def measure_rebuild():
    """
    Accepted-transition throughput of the textbook (duplicate-on-reject)
    HMC kernel, swept over chain-batch sizes to chip saturation. Throughput
    per tier is attempts/sec times the measured acceptance fraction — the
    same quantity the reference's steps/sec measures (the reference
    re-proposes serially until acceptance, so its per-step cost already
    includes rejected attempts).

    Returns (per-tier throughput dict, peak throughput, acceptance). The
    sweep shows where dispatch overhead stops mattering (throughput stops
    scaling with batch once the device is busy).
    """
    import jax
    import jax.numpy as jnp
    from inference_tpu.parallel import ChainArray

    icov = jnp.asarray(np.linalg.inv(make_cov()), jnp.float32)

    def logp(t):
        return -0.5 * t @ icov @ t

    rng = np.random.default_rng(0)
    results = {}
    accept = None
    for n_chains in CHAIN_SWEEP:
        steps = max(32, WORK_PER_TIER // n_chains)
        starts = rng.normal(0, 0.1, size=(n_chains, N_DIM))
        ca = ChainArray(
            "hmc", logp, starts, steps=HMC_STEPS, epsilon=0.25, seed=1,
            retry=False,
        )
        # warm-up with the SAME scan length as the timed run: every
        # distinct scan length compiles a separate program
        ca.advance(steps, store=False)
        if accept is None:
            # acceptance fraction (position changed => accepted); constant
            # across tiers (same posterior / epsilon / adaptation target)
            ca.advance(32, store=True)
            theta = np.concatenate(ca._history, axis=0)
            accept = float(
                (np.abs(np.diff(theta, axis=0)).max(axis=2) > 0).mean()
            )
        t0 = time.perf_counter()
        ca.advance(steps, store=False)
        jax.block_until_ready(ca._state)
        dt = time.perf_counter() - t0
        results[n_chains] = n_chains * steps / dt * accept

    return results, max(results.values()), accept


def measure_reference() -> float:
    """Single-core reference HamiltonianChain throughput (steps/sec), or
    NaN when the reference package (``inference``) is not importable."""
    mod = types.ModuleType("setuptools_scm")
    mod.get_version = lambda **k: "0.0.0"
    sys.modules.setdefault("setuptools_scm", mod)
    try:
        from inference.mcmc import HamiltonianChain
    except ImportError:
        return float("nan")

    icov = np.linalg.inv(make_cov())

    def posterior(t):
        return float(-0.5 * t @ icov @ t)

    def grad(t):
        return -icov @ t

    chain = HamiltonianChain(
        posterior=posterior,
        grad=grad,
        start=np.random.default_rng(0).normal(0, 0.1, N_DIM),
        epsilon=0.25,
        display_progress=False,
    )
    # warm up adaptation briefly
    for _ in range(20):
        chain.take_step()
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < REF_TIME_BUDGET:
        for _ in range(10):
            chain.take_step()
        n += 10
    dt = time.perf_counter() - t0
    return n / dt


def main():
    from inference_tpu.utils.accelerator import (
        card_identity, device_record, enable_compile_cache, require_gpu,
    )

    devices = require_gpu("bench")
    enable_compile_cache()
    results, peak, accept = measure_rebuild()
    ref = measure_reference()
    vs = peak / ref if np.isfinite(ref) and ref > 0 else None
    print(
        json.dumps(
            {
                "metric": "hmc_samples_per_sec_per_chip",
                "value": round(peak, 1),
                "unit": "samples/s (batched HMC at saturating chain count, "
                "10-dim correlated Gaussian)",
                "vs_baseline": round(vs, 1) if vs is not None else None,
                "scaling": {str(k): round(v) for k, v in results.items()},
                "acceptance": round(accept, 3),
                "device": device_record(devices[:1]),
                "card": card_identity(),
            }
        )
    )


if __name__ == "__main__":
    main()
