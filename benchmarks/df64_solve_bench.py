"""End-to-end df64 training solve: stored-entries tier vs
evaluate-per-matvec.

The stored tier (`ops/df64.py::sqexp_entries_df64` +
`sqexp_stored_matmat_df64`) materialises the covariance pair entries
once (8 bytes/entry of device memory) so every PCG iteration is a
contraction instead of a d^2 + exp evaluation per entry. This measures
the end-to-end effect on the `LargeScaleGP(solver="df64")` training
solve at sigma = 0.01.

Usage: python benchmarks/df64_solve_bench.py [N]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16_384

    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    # sanity op before trusting the worker (see BENCH_NOTES practical notes)
    assert float(jnp.ones(8).sum()) == 8.0
    print(f"backend: {jax.default_backend()}, N={n}", flush=True)

    from inference_tpu.gp import LargeScaleGP

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.01, n)
    err = np.full(n, 0.01)
    theta = np.array([0.0, 0.0, 0.0])

    times = {}
    for store in (False, True):
        label = "stored" if store else "fused"
        t0 = time.perf_counter()
        gp = LargeScaleGP(
            x, y, err, hyperpars=theta, block_size=4096,
            preconditioner_rank=512, solver="df64", cg_tol=1e-9,
            cg_maxiter=3000, dtype="float32", store_entries=store,
        )
        times[label] = time.perf_counter() - t0
        res = gp.residual_norm_f64(residual_backend="df64")
        print(
            f"{label}: constructor+solve {times[label]:.1f} s, "
            f"f64 residual {res:.2e}",
            flush=True,
        )
        del gp

    print(
        f"stored-entries end-to-end speedup: "
        f"{times['fused'] / times['stored']:.2f}x",
        flush=True,
    )


if __name__ == "__main__":
    main()
