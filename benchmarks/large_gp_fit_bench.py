"""Matrix-free hyperparameter fitting at large N on the GPU.

`LargeScaleGP.fit()` — Adam on Hutchinson-trace stochastic LML gradients,
one batched multi-RHS CG solve per step (all systems share each blocked
kernel matmul). The reference's `GpRegressor.fit` factorises dense K
per objective evaluation (inference/gp/regression.py:528-567) and is
out of memory long before this scale.

Usage: python benchmarks/large_gp_fit_bench.py [N] [n_steps] [precond_rank]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16_384
    n_steps = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    rank = int(sys.argv[3]) if len(sys.argv) > 3 else 512

    import jax

    # x64 ON: fit()'s preconditioner core application needs float64 —
    # the f32-applied core diverges at this scale (see BENCH_NOTES)
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    assert float(jnp.ones(8).sum()) == 8.0
    print(f"backend: {jax.default_backend()}, N={n}", flush=True)

    from inference_tpu.gp import LargeScaleGP

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
    err = np.full(n, 0.1)
    theta0 = np.array([0.5, 1.2, 1.2])  # deliberately bad init

    gp = LargeScaleGP(
        x, y, err, hyperpars=theta0, block_size=4096,
        preconditioner_rank=rank, cg_tol=1e-4, cg_maxiter=400,
        dtype="float32",  # x64 is on for the f64 preconditioner core only
    )

    t0 = time.perf_counter()
    theta1 = gp.fit(n_steps=1, learning_rate=0.1, n_probes=8, seed=0)
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    theta_fit = gp.fit(
        n_steps=n_steps, learning_rate=0.1, n_probes=8, seed=0,
        fit_tol=1e-3, fit_maxiter=150, verbose=True,
    )
    t_fit = time.perf_counter() - t0
    print(
        f"fit: {n_steps} steps in {t_fit:.1f} s ({t_fit/n_steps:.2f} s/step; "
        f"first-step compile+run {t_compile:.1f} s)", flush=True,
    )
    print(f"theta: {theta0} -> {theta_fit.round(4)}", flush=True)

    # quality: refit at the selected hyperparameters, report residual and
    # prediction error vs the generating function
    gp2 = LargeScaleGP(
        x, y, err, hyperpars=theta_fit, block_size=4096,
        preconditioner_rank=512, cg_tol=1e-6, dtype="float32",
    )
    q = rng.uniform(1, 9, size=(256, 2))
    mu = gp2(q)
    rms = float(np.sqrt(np.mean((mu - np.sin(q[:, 0]) * np.cos(q[:, 1])) ** 2)))
    print(
        f"refit at theta_fit: residual {gp2.residual_norm():.2e}, "
        f"prediction rms vs truth {rms:.4f}", flush=True,
    )


if __name__ == "__main__":
    main()
