"""Matrix-free GP at very large N (BASELINE stretch config #5 scale):
training solve + predictions at N = 50,000 on one device, where dense
factorisation (O(N^2) memory) no longer fits and the reference's
N x N x D precompute is a hard memory wall.

Usage: python benchmarks/large_gp_bench.py [N]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50_000
    from inference_tpu.gp import LargeScaleGP

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
    err = np.full(n, 0.1)
    theta = np.array([0.0, 0.0, 0.0])  # ln A, ln l1, ln l2

    t0 = time.perf_counter()
    gp = LargeScaleGP(
        x,
        y,
        err,
        hyperpars=theta,
        block_size=4096,
        preconditioner_rank=4096,
        cg_tol=1e-4,
        cg_maxiter=500,
    )
    fit_time = time.perf_counter() - t0
    print(f"N={n}: CG training solve in {fit_time:.2f}s "
          f"(relative residual {gp.residual_norm():.2e})", flush=True)

    q = rng.uniform(1, 9, size=(256, 2))
    mu = gp(q)  # compile
    t0 = time.perf_counter()
    mu = gp(q)
    pred_time = time.perf_counter() - t0
    truth = np.sin(q[:, 0]) * np.cos(q[:, 1])
    rms = float(np.sqrt(np.mean((mu - truth) ** 2)))
    print(f"256 mean predictions in {pred_time * 1e3:.1f} ms "
          f"(rms error vs truth {rms:.4f})", flush=True)


if __name__ == "__main__":
    main()
