"""4096-walker EnsembleSampler throughput (BASELINE.json stretch config):
vectorised red/black stretch moves vs the reference's sequential walker
loop, on a 10-dim correlated Gaussian.

Usage: python benchmarks/ensemble_bench.py [n_walkers] [iterations]
"""

import os
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DIM = 10


def make_problem(n_walkers, seed=0):
    rng = np.random.default_rng(42)
    A = rng.normal(size=(N_DIM, N_DIM)) / np.sqrt(N_DIM)
    cov = A @ A.T + np.eye(N_DIM)
    icov = np.linalg.inv(cov)
    starts = np.random.default_rng(seed).normal(0, 0.3, size=(n_walkers, N_DIM))
    return icov, starts


def time_rebuild(n_walkers, iterations):
    import jax
    import jax.numpy as jnp
    from inference_tpu.mcmc import EnsembleSampler
    from inference_tpu.mcmc._kernels.ensemble import (
        make_ensemble_step,
        init_ensemble_state,
        run_steps,
    )

    icov_np, starts = make_problem(n_walkers)
    icov = jnp.asarray(icov_np, jnp.float32)

    def logp(t):
        return -0.5 * t @ icov @ t

    # full facade path (includes per-chunk history offload to the host)
    es = EnsembleSampler(
        logp,
        starting_positions=starts,
        display_progress=False,
        seed=1,
        retry=False,
    )
    # warm-up with the same iteration count: each distinct scan length
    # compiles a separate program
    es.advance(iterations)
    jax.block_until_ready(es._state.walkers)
    t0 = time.perf_counter()
    es.advance(iterations)
    jax.block_until_ready(es._state.walkers)
    facade = n_walkers * iterations / (time.perf_counter() - t0)
    # history consolidation: one bulk device->host fetch of everything
    t0 = time.perf_counter()
    sample = es.sample
    fetch = time.perf_counter() - t0
    print(
        f"history fetch:           {sample.nbytes / 2**20:.0f} MB in "
        f"{fetch:.2f} s ({sample.nbytes / 2**20 / max(fetch, 1e-9):.0f} MB/s)"
    )

    # device-resident sampling loop only (history stays on device)
    step = make_ensemble_step(logp, n_walkers=n_walkers, retry=False)
    sd = jnp.asarray(starts, jnp.float32)
    state = init_ensemble_state(sd, jax.vmap(logp)(sd), jax.random.PRNGKey(0))
    state, _ = run_steps(step, state, iterations)
    jax.block_until_ready(state.walkers)
    t0 = time.perf_counter()
    state, _ = run_steps(step, state, iterations)
    jax.block_until_ready(state.walkers)
    device = n_walkers * iterations / (time.perf_counter() - t0)
    return facade, device


def time_reference(n_walkers, iterations):
    mod = types.ModuleType("setuptools_scm")
    mod.get_version = lambda **k: "0.0.0"
    sys.modules.setdefault("setuptools_scm", mod)
    sys.path.insert(0, "/root/reference")
    try:
        from inference.mcmc import EnsembleSampler as RefEs
    except Exception:
        return None

    icov, starts = make_problem(n_walkers)

    def logp(t):
        return float(-0.5 * t @ icov @ t)

    es = RefEs(logp, starting_positions=starts, display_progress=False)
    es.advance(2)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < 5.0 and n < iterations:
        es.advance(1)
        n += 1
    dt = time.perf_counter() - t0
    return n_walkers * n / dt


def main():
    n_walkers = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    iterations = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    facade, device = time_rebuild(n_walkers, iterations)
    print(f"rebuild (device loop):   {device:12,.0f} walker-updates/s "
          f"({n_walkers} walkers x {iterations} iterations)")
    print(f"rebuild (with history):  {facade:12,.0f} walker-updates/s "
          f"(history device-resident, fetched lazily)")
    ref = time_reference(min(n_walkers, 512), 20)
    if ref:
        print(f"reference:               {ref:12,.0f} walker-updates/s "
              f"(measured at {min(n_walkers, 512)} walkers)")
        print(f"device ratio:            {device / ref:10.1f}x")


if __name__ == "__main__":
    main()
