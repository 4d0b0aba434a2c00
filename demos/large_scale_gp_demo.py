"""LargeScaleGP demo (beyond the reference's GpRegressor scale):
matrix-free GP regression on 50,000 points — the covariance matrix is
never materialised; blocked kernel matvecs drive preconditioned conjugate
gradients."""

import time

import numpy as np

from inference_tpu.gp import LargeScaleGP


def main():
    rng = np.random.default_rng(0)
    N = 50_000
    x = rng.uniform(0, 100, size=(N, 2))
    truth = np.sin(0.3 * x[:, 0]) * np.cos(0.2 * x[:, 1])
    sigma = 0.1
    y = truth + sigma * rng.normal(size=N)

    t0 = time.time()
    gp = LargeScaleGP(
        x,
        y,
        y_err=np.full(N, sigma),
        hyperpars=[0.0, np.log(3.0), np.log(3.0)],  # ln A, ln l1, ln l2
        preconditioner="pivchol",  # on-device pivoted-Cholesky preconditioner
        preconditioner_rank=1024,
    )
    print(f"training solve (N={N:,}): {time.time() - t0:.1f}s")
    print(f"relative residual: {gp.residual_norm():.2e}")

    q = np.stack([np.linspace(5, 95, 500), np.linspace(5, 95, 500)], axis=1)
    t0 = time.time()
    mu = gp(q)
    print(f"500 predictions: {time.time() - t0:.2f}s")
    rms = np.sqrt(np.mean((mu - np.sin(0.3 * q[:, 0]) * np.cos(0.2 * q[:, 1])) ** 2))
    print(f"prediction rms error: {rms:.4f}  (noise level {sigma})")


if __name__ == "__main__":
    main()
