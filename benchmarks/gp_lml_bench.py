"""GP marginal-likelihood + gradient throughput vs dataset size N
(BASELINE.md north-star #2: LML+grad evals/sec at N=16k).

Times the jitted value_and_grad of the LML (covariance assembly, Cholesky,
triangular solves, the gradient path ``cholesky="auto"`` picks) and —
for small N where it is feasible — the reference implementation's
``marginal_likelihood_gradient`` on the same data.

Usage: python benchmarks/gp_lml_bench.py [N ...]
"""

import os
import sys
import time
import types

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def make_data(n, d=2, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, d))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
    return x, y, np.full(n, 0.1)


def model_flops(n, d=2):
    """Model-FLOP estimate for one LML value+gradient evaluation:
    covariance assembly ~ (3d+3) N^2 (forward) and a similar backward
    reduction, Cholesky N^3/3, its VJP ~ 2/3 N^3 (triangular solves with
    matrix right-hand sides), triangular solve + quadratic form ~ 3 N^2.
    The N^3 terms dominate at every benchmarked size."""
    return n**3 + (6 * d + 9) * n**2


def time_rebuild(n, cholesky="auto"):
    import jax.numpy as jnp
    from inference_tpu.gp import GpRegressor

    x, y, err = make_data(n)
    theta = np.array([0.0, 0.0, 0.5, 0.5])
    # float32 regardless of the process's x64 setting
    gp = GpRegressor(
        x, y, y_err=err, hyperpars=theta, dtype="float32",
        cholesky=cholesky,
    )

    gp.marginal_likelihood_gradient(theta)  # compile
    reps = 10 if n <= 8192 else 3
    t0 = time.perf_counter()
    for _ in range(reps):
        lml, grad = gp.marginal_likelihood_gradient(theta)
    dt = (time.perf_counter() - t0) / reps
    return dt, lml


def time_reference(n):
    mod = types.ModuleType("setuptools_scm")
    mod.get_version = lambda **k: "0.0.0"
    sys.modules.setdefault("setuptools_scm", mod)
    sys.path.insert(0, "/root/reference")
    try:
        from inference.gp import GpRegressor as RefGp
    except Exception:
        return None, None

    x, y, err = make_data(n)
    theta = np.array([0.0, 0.0, 0.5, 0.5])
    gp = RefGp(x, y, y_err=err, hyperpars=theta)
    gp.marginal_likelihood_gradient(theta)
    t0 = time.perf_counter()
    for _ in range(3):
        lml, grad = gp.marginal_likelihood_gradient(theta)
    dt = (time.perf_counter() - t0) / 3
    return dt, lml


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [2048, 8192, 16384]
    for n in sizes:
        dt, lml = time_rebuild(n)
        tflops = model_flops(n) / dt / 1e12
        line = (
            f"N={n:6d}: rebuild {1 / dt:8.2f} evals/s ({dt * 1e3:8.1f} ms), "
            f"{tflops:6.2f} TFLOP/s, lml={lml:.4f}"
        )
        if n <= 4096:
            ref_dt, ref_lml = time_reference(n)
            if ref_dt:
                line += (
                    f" | reference {1 / ref_dt:6.2f} evals/s "
                    f"({ref_dt * 1e3:8.1f} ms) -> {ref_dt / dt:6.1f}x"
                )
        print(line, flush=True)
        if n >= 4096:
            # the "auto" policy (measured per-program choice) against the
            # pure-expander and pure-blocked backends, end to end through
            # the same LML value+gradient program
            for backend in ("xla", "blocked", "analytic"):
                dt_b, lml_b = time_rebuild(n, cholesky=backend)
                tflops_b = model_flops(n) / dt_b / 1e12
                print(
                    f"N={n:6d}: cholesky={backend:7s} "
                    f"{1 / dt_b:8.2f} evals/s ({dt_b * 1e3:8.1f} ms), "
                    f"{tflops_b:6.2f} TFLOP/s ({dt / dt_b:5.2f}x vs auto), "
                    f"dlml={abs(lml_b - lml):.2e}",
                    flush=True,
                )


if __name__ == "__main__":
    main()
