"""One perf harness, machine-readable: every flagship metric in one JSON.

Runs a curated single-configuration measurement of each headline workload
on an NVIDIA GPU (the focused per-topic scripts in this directory remain
the place for sweeps and ablations) and emits ONE JSON object to stdout,
also written to ``benchmarks/results_latest.json`` (not committed). It
exits non-zero without a GPU, and non-zero if any workload fails.

Metrics (reference equivalents cited in the per-topic scripts):
  hmc_10d            batched HMC samples/s, 10-dim Gaussian (bench.py config)
  dense_hmc_p256     P=256 full-MatrixMass HMC samples/s
  ensemble_4096      vectorised stretch-move walker-iterations/s
  tempering          8-rung replica exchange steps/s/rung
  nuts_10d           batched NUTS transitions/s
  gp_lml             LML value+gradient evals/s at N=2048/8192/16384
  bo_warm            warm fused BO iteration median seconds
  df64_solve_16k     sigma=0.01 stored-entries df64 solve seconds + residual
  df64_solve_50k     sigma=0.01 stored-f32 df64 solve (cold + warm) + residual

Usage: python benchmarks/run_all.py [--only name1,name2] [--skip name1,...]
"""

import json
import os
import sys
import time
import traceback

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

def _correlated_gaussian(n_dim, seed=42):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_dim, n_dim)) / np.sqrt(n_dim)
    return A @ A.T + np.eye(n_dim)


def bench_hmc_10d():
    import jax
    import jax.numpy as jnp
    from inference_tpu.parallel import ChainArray

    n_dim, n_chains, hmc_steps = 10, 65536, 50
    icov = jnp.asarray(np.linalg.inv(_correlated_gaussian(n_dim)), jnp.float32)
    logp = lambda t: -0.5 * t @ icov @ t
    starts = np.random.default_rng(0).normal(0, 0.1, size=(n_chains, n_dim))
    ca = ChainArray(
        "hmc", logp, starts, steps=hmc_steps, epsilon=0.25, seed=1, retry=False
    )
    steps = 64
    ca.advance(steps, store=False)  # warm (same scan length)
    ca.advance(32, store=True)
    theta = np.concatenate(ca._history, axis=0)
    accept = float((np.abs(np.diff(theta, axis=0)).max(axis=2) > 0).mean())
    t0 = time.perf_counter()
    ca.advance(steps, store=False)
    jax.block_until_ready(ca._state)
    dt = time.perf_counter() - t0
    rate = n_chains * steps * accept / dt
    return {
        "samples_per_sec": rate,
        "acceptance": accept,
        "n_chains": n_chains,
        "unit": "accepted transitions/s (10-dim Gaussian, 50 leapfrogs)",
    }


def bench_dense_hmc_p256():
    import jax
    import jax.numpy as jnp
    from inference_tpu.parallel import ChainArray

    P, n_chains, hmc_steps = 256, 8192, 20
    cov = _correlated_gaussian(P)
    cov = 0.9 * cov + 0.1 * np.eye(P)
    icov = jnp.asarray(np.linalg.inv(cov), jnp.float32)
    logp = lambda t: -0.5 * t @ icov @ t
    starts = np.random.default_rng(0).normal(0, 0.1, size=(n_chains, P))
    ca = ChainArray(
        "hmc", logp, starts, steps=hmc_steps, epsilon=0.1, seed=1,
        inverse_mass=np.asarray(cov, np.float32), retry=False,
    )
    steps = 256
    ca.advance(steps, store=False)
    ca.advance(16, store=True)
    theta = np.concatenate(ca._history, axis=0)
    accept = float((np.abs(np.diff(theta, axis=0)).max(axis=2) > 0).mean())
    t0 = time.perf_counter()
    ca.advance(steps, store=False)
    jax.block_until_ready(ca._state)
    dt = time.perf_counter() - t0
    rate = n_chains * steps * accept / dt
    # per attempted transition: each leapfrog does a gradient matvec
    # (2P^2) and a mass-velocity matvec (2P^2); plus 2 logp evals
    fpt = hmc_steps * 4 * P**2 + 2 * 2 * P**2
    return {
        "samples_per_sec": rate,
        "acceptance": accept,
        "tflops": (rate / accept) * fpt / 1e12,
        "n_chains": n_chains,
        "unit": "accepted transitions/s (P=256, full MatrixMass)",
    }


def bench_ensemble_4096():
    import jax
    import jax.numpy as jnp
    from inference_tpu.mcmc import EnsembleSampler

    n_dim, n_walkers, iters = 10, 4096, 512
    icov = jnp.asarray(np.linalg.inv(_correlated_gaussian(n_dim)), jnp.float32)
    logp = lambda t: -0.5 * t @ icov @ t
    starts = np.random.default_rng(0).normal(0, 0.3, size=(n_walkers, n_dim))
    es = EnsembleSampler(
        logp, starting_positions=starts, display_progress=False, seed=1,
        retry=False,
    )
    es.advance(iters)
    jax.block_until_ready(es._state.walkers)
    t0 = time.perf_counter()
    es.advance(iters)
    jax.block_until_ready(es._state.walkers)
    dt = time.perf_counter() - t0
    return {
        "walker_iterations_per_sec": n_walkers * iters / dt,
        "unit": "walker-iterations/s (4096 walkers, 10-dim Gaussian)",
    }


def bench_tempering():
    import jax.numpy as jnp
    from inference_tpu.mcmc import GibbsChain, ParallelTempering

    temps = [1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0]

    def bimodal(t):
        x = t[0]
        return jnp.logaddexp(
            -0.5 * ((x + 4.0) / 0.5) ** 2,
            -0.5 * ((x - 4.0) / 0.5) ** 2 + jnp.log(0.5),
        )

    chains = [
        GibbsChain(
            bimodal, start=np.array([4.0]), widths=np.array([0.3]),
            temperature=T, display_progress=False, seed=i,
        )
        for i, T in enumerate(temps)
    ]
    pt = ParallelTempering(chains)
    n_steps = 2000
    pt.advance(n_steps, swap_interval=10)  # warm
    t0 = time.perf_counter()
    pt.advance(n_steps, swap_interval=10)
    dt = time.perf_counter() - t0
    pt.shutdown()
    return {
        "steps_per_sec_per_rung": n_steps / dt,
        "unit": "steps/s/rung (8 rungs, swap_interval=10)",
    }


def bench_nuts_10d():
    import jax
    import jax.numpy as jnp
    from inference_tpu.parallel import ChainArray

    n_dim, n_chains = 10, 16384
    icov = jnp.asarray(np.linalg.inv(_correlated_gaussian(n_dim)), jnp.float32)
    logp = lambda t: -0.5 * t @ icov @ t
    starts = np.random.default_rng(0).normal(0, 0.1, size=(n_chains, n_dim))
    ca = ChainArray("nuts", logp, starts, seed=1, epsilon=0.25, max_depth=8)
    steps = 128
    ca.advance(steps, store=False)
    t0 = time.perf_counter()
    ca.advance(steps, store=False)
    jax.block_until_ready(ca._state)
    dt = time.perf_counter() - t0
    return {
        "transitions_per_sec": n_chains * steps / dt,
        "n_chains": n_chains,
        "unit": "NUTS transitions/s (10-dim Gaussian, max_depth=8)",
    }


def bench_gp_lml():
    from inference_tpu.gp import GpRegressor

    out = {}
    theta = np.array([0.0, 0.0, 0.5, 0.5])
    for n in (2048, 8192, 16384):
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 10, size=(n, 2))
        y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
        gp = GpRegressor(
            x, y, y_err=np.full(n, 0.1), hyperpars=theta, dtype="float32"
        )
        gp.marginal_likelihood_gradient(theta)  # compile
        reps = 10 if n <= 8192 else 3
        t0 = time.perf_counter()
        for _ in range(reps):
            gp.marginal_likelihood_gradient(theta)
        dt = (time.perf_counter() - t0) / reps
        out[f"n{n}"] = {"evals_per_sec": 1.0 / dt, "seconds_per_eval": dt}
        del gp
    out["unit"] = "LML value+gradient evals/s (cholesky='auto')"
    return out


def bench_bo_warm():
    from inference_tpu.gp import GpOptimiser

    def objective(x):
        x = np.atleast_2d(x)
        return float(
            -np.sum((x - 3.14) ** 2, axis=1)
            + np.sin(3.0 * x[:, 0]) * np.cos(2.0 * x[:, 1])
        )

    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, 6, size=(6, 2))
    y0 = np.array([objective(p) for p in x0])
    opt = GpOptimiser(
        x0, y0, bounds=[(0.0, 6.0), (0.0, 6.0)], optimizer="device"
    )
    for _ in range(2):  # warm both program shapes
        xq = opt.propose_evaluation()
        opt.add_evaluation(xq, objective(xq))
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        xq = opt.propose_evaluation()
        opt.add_evaluation(xq, objective(xq))
        times.append(time.perf_counter() - t0)
    return {
        "median_iteration_seconds": float(np.median(times)),
        "unit": "warm fused BO iteration (propose + objective + add)",
    }


def bench_df64_solve_16k():
    import jax

    # the sampler benches above run in float32; the df64 tiers need x64
    # scalars/vectors. These benches run LAST so the switch is safe.
    jax.config.update("jax_enable_x64", True)
    from inference_tpu.gp import LargeScaleGP

    n = 16384
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.01, n)
    t0 = time.perf_counter()
    gp = LargeScaleGP(
        x, y, np.full(n, 0.01), hyperpars=np.array([0.0, 0.0, 0.0]),
        block_size=4096, preconditioner_rank=512, solver="df64",
        cg_tol=1e-9, cg_maxiter=3000, dtype="float32", store_entries=True,
    )
    dt = time.perf_counter() - t0
    res = gp.residual_norm_f64(residual_backend="df64")
    return {
        "constructor_plus_solve_seconds": dt,
        "f64_residual": float(res),
        "unit": "N=16,384 sigma=0.01 stored-entries df64 training solve",
    }


def bench_df64_solve_50k():
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from inference_tpu.gp import LargeScaleGP

    n = 50_000
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.01, n)
    t0 = time.perf_counter()
    gp = LargeScaleGP(
        x, y, np.full(n, 0.01), hyperpars=np.array([0.0, 0.0, 0.0]),
        block_size=4096, preconditioner_rank=512, solver="df64",
        cg_tol=1e-9, cg_maxiter=3000, dtype="float32", store_entries="auto",
    )
    dt_cold = time.perf_counter() - t0
    res = gp.residual_norm_f64(residual_backend="df64")
    rhs = (np.asarray(gp._y_host) - gp.mean_value) * gp._mask
    t0 = time.perf_counter()
    alpha, info = gp._df64_solver.solve(
        jnp.asarray(rhs).astype(jnp.float64), tol=1e-9, maxiter=3000
    )
    jax.block_until_ready(alpha)
    dt_warm = time.perf_counter() - t0
    return {
        "constructor_plus_solve_seconds": dt_cold,
        "warm_solve_seconds": dt_warm,
        "warm_info": int(info),
        "f64_residual": float(res),
        "unit": "N=50,000 sigma=0.01 stored-f32 df64 training solve",
    }


BENCHES = {
    "hmc_10d": bench_hmc_10d,
    "dense_hmc_p256": bench_dense_hmc_p256,
    "ensemble_4096": bench_ensemble_4096,
    "tempering": bench_tempering,
    "nuts_10d": bench_nuts_10d,
    "gp_lml": bench_gp_lml,
    "bo_warm": bench_bo_warm,
    "df64_solve_16k": bench_df64_solve_16k,
    "df64_solve_50k": bench_df64_solve_50k,
}


def main():
    only, skip = None, set()
    args = sys.argv[1:]
    while args:
        a = args.pop(0)
        if a == "--only":
            only = set(args.pop(0).split(","))
        elif a == "--skip":
            skip = set(args.pop(0).split(","))
        else:
            raise SystemExit(f"unknown argument {a!r}")

    from inference_tpu.utils.accelerator import (
        card_identity, device_record, enable_compile_cache, require_gpu,
    )

    devices = require_gpu("run_all")
    enable_compile_cache()
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "results_latest.json")
    results = {"metrics": {}}
    if only is not None and os.path.exists(path):
        # partial re-runs merge into the existing sweep instead of
        # clobbering the other metrics
        with open(path) as f:
            results = json.load(f)
    results["device"] = device_record(devices[:1])
    results["card"] = card_identity()
    failed = []
    for name, fn in BENCHES.items():
        if (only is not None and name not in only) or name in skip:
            continue
        print(f"[run_all] {name} ...", file=sys.stderr, flush=True)
        t0 = time.perf_counter()
        try:
            results["metrics"][name] = fn()
        except Exception:  # record every bench's failure, then exit non-zero
            results["metrics"][name] = {"error": traceback.format_exc(limit=3)}
            failed.append(name)
        results["metrics"][name]["wall_seconds"] = time.perf_counter() - t0

    with open(path, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results))
    if failed:
        raise SystemExit(f"[ run_all ] failed benches: {', '.join(failed)}")


if __name__ == "__main__":
    main()
