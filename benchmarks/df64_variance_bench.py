"""Batched df64 posterior-variance solves on the GPU.

Measures (a) the per-column amortisation of the multi-RHS df64 matmat
(`ops/df64.py::sqexp_matmat_df64`) against the single-RHS
matvec, and (b) the end-to-end `LargeScaleGP(solver="df64")` variance
path at N=16,384, sigma=0.01 — the small-noise regime where the
amp^2 - quad cancellation needs float64 accuracy throughout
(reference computes this dense in host f64: inference/gp/regression.py:204-216).

Accuracy is checked against a dense host float64 solve (~2 GB, ~1 min).

Usage: python benchmarks/df64_variance_bench.py [N] [n_queries]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16_384
    m = int(sys.argv[2]) if len(sys.argv) > 2 else 16

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    # sanity op before trusting the worker (see BENCH_NOTES practical notes)
    assert float(jnp.ones(8).sum()) == 8.0
    print(f"backend: {jax.default_backend()}", flush=True)

    from inference_tpu.gp import LargeScaleGP
    from inference_tpu.ops.df64 import (
        split_f64, sqexp_matvec_df64, sqexp_matmat_df64,
    )

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.01, n)
    err = np.full(n, 0.01)
    theta = np.array([0.0, 0.0, 0.0])

    # ---------------- kernel amortisation ---------------- #
    uh, ul = split_f64(x)
    v = rng.normal(size=n)
    V = rng.normal(size=(n, 8))

    def timed(f, reps=3):
        f()  # warm compile
        t0 = time.perf_counter()
        acc = 0.0
        for _ in range(reps):
            acc += float(np.asarray(f()).sum())  # force materialisation
        return (time.perf_counter() - t0) / reps, acc

    t_vec, _ = timed(lambda: sqexp_matvec_df64(uh, ul, v))
    t_mat, _ = timed(lambda: sqexp_matmat_df64(uh, ul, V))
    print(
        f"N={n}: matvec {t_vec*1e3:.0f} ms; matmat q=8 {t_mat*1e3:.0f} ms "
        f"({t_mat/t_vec:.2f}x one matvec = {t_mat/(8*t_vec):.2f}x per "
        f"column; model (190+40q)/230q = {(190+40*8)/(230*8):.2f})",
        flush=True,
    )

    # bitwise agreement column-by-column with the single-RHS kernel
    Y = np.asarray(sqexp_matmat_df64(uh, ul, V))
    y0 = np.asarray(sqexp_matvec_df64(uh, ul, V[:, 0]))
    print(f"matmat vs matvec col-0 bitwise: {np.array_equal(Y[:, 0], y0)}",
          flush=True)

    # ---------------- end-to-end variance path ---------------- #
    t0 = time.perf_counter()
    gp = LargeScaleGP(
        x, y, err, hyperpars=theta, block_size=4096,
        preconditioner_rank=512, solver="df64", cg_tol=1e-9,
        cg_maxiter=3000, dtype="float32",
    )
    t_fit = time.perf_counter() - t0
    print(f"fit (mean solve) {t_fit:.0f} s; residual "
          f"{gp.residual_norm_f64(residual_backend='df64'):.2e}", flush=True)

    q = rng.uniform(1, 9, size=(m, 2))
    t0 = time.perf_counter()
    mu, sig = gp(q, with_variance=True)
    t_var = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu, sig = gp(q, with_variance=True)
    t_var_warm = time.perf_counter() - t0
    print(f"{m} variance queries: {t_var:.1f} s cold, {t_var_warm:.1f} s warm "
          f"({t_var_warm/m*1e3:.0f} ms/query)", flush=True)

    # host float64 dense ground truth
    print("building dense f64 ground truth on host ...", flush=True)
    t0 = time.perf_counter()
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    K = np.exp(-0.5 * d2)
    K[np.diag_indices(n)] += err**2 + 1e-12
    d2q = ((q[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    Kqx = np.exp(-0.5 * d2q)
    sol = np.linalg.solve(K, Kqx.T)
    var_ref = 1.0 - np.einsum("ij,ji->i", Kqx, sol)
    mu_ref = Kqx @ np.linalg.solve(K, y - y.mean()) + y.mean()
    t_host = time.perf_counter() - t0
    print(f"host dense solve {t_host:.0f} s", flush=True)

    verr = np.abs(np.asarray(sig) ** 2 - var_ref)
    merr = np.abs(np.asarray(mu) - mu_ref)
    print(
        f"variance truth range [{var_ref.min():.3e}, {var_ref.max():.3e}]; "
        f"max abs err {verr.max():.3e} (rel {(verr/np.abs(var_ref)).max():.3e}); "
        f"mean max abs err {merr.max():.3e}",
        flush=True,
    )


if __name__ == "__main__":
    main()
