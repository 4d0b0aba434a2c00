"""Warm GpOptimiser iteration latency on the GPU.

Round 3 fused the warm BO iteration (add_evaluation + the next
propose_evaluation) into ONE compiled device program with
optimizer="device" — this measures the end-to-end warm iteration
(propose + objective + add) that round 2 clocked at 0.9-1.4 s over 3-4
dispatches.

Usage: python benchmarks/bo_warm_bench.py [n_iterations]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def objective(x):
    x = np.atleast_2d(x)
    return float(
        -np.sum((x - 3.14) ** 2, axis=1)
        + np.sin(3.0 * x[:, 0]) * np.cos(2.0 * x[:, 1])
    )


def main():
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 10

    import jax
    import jax.numpy as jnp

    assert float(jnp.ones(8).sum()) == 8.0
    print(f"backend: {jax.default_backend()}", flush=True)

    from inference_tpu.gp import GpOptimiser

    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, 6, size=(6, 2))
    y0 = np.array([objective(p) for p in x0])
    bounds = [(0.0, 6.0), (0.0, 6.0)]
    opt = GpOptimiser(x0, y0, bounds=bounds, optimizer="device")

    # warm-up: exercise every program shape (propose + add) twice
    for _ in range(2):
        xq = opt.propose_evaluation()
        opt.add_evaluation(xq, objective(xq))

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        xq = opt.propose_evaluation()
        opt.add_evaluation(xq, objective(xq))
        times.append(time.perf_counter() - t0)
    times = np.array(times)
    print(
        f"warm BO iteration (propose + objective + add): median "
        f"{np.median(times):.2f} s, min {times.min():.2f} s, max "
        f"{times.max():.2f} s over {iters} iterations", flush=True,
    )
    print(f"best objective: {opt.y.max():.4f}", flush=True)


if __name__ == "__main__":
    main()
