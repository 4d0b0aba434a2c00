"""Compute-dense sampling: batched HMC on matmul-shaped posteriors.

The headline HMC benchmark (bench.py) is a 10-dim Gaussian — an
elementwise workload: it demonstrates dispatch-overhead amortisation,
not arithmetic throughput. This bench shows the sampler stack feeding
the matrix units when the posterior has arithmetic to offer:

1. P=256 correlated Gaussian with a full matrix inverse-mass — each
   leapfrog step is two (chains, P) x (P, P) matmuls (the gradient and
   the mass-velocity map), the device-batched form of the reference's
   ``MatrixMass`` kinetic energy (reference: inference/mcmc/hmc/mass.py:
   57-94).
2. A linear-forward-model ``GaussianLikelihood`` posterior (N_data=1024,
   P=256) through the model-building blocks (``models.likelihoods``,
   reference: inference/likelihoods.py:122-167): each gradient is a pair
   of (chains, P) x (P, N_data) matmuls.

Sweeps the chain batch to saturation; reports samples/s and model
TFLOP/s (matmuls run at default precision, exactly as a throughput-hungry
user would run them).

Usage: python benchmarks/dense_hmc_bench.py [n_chains ...]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

P = 256
N_DATA = 1024
HMC_STEPS = 20


def correlated_gaussian():
    """(logp, inverse_mass): a P-dim correlated Gaussian and the matched
    full matrix mass (inverse_mass = covariance)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(42)
    A = rng.normal(size=(P, P)) / np.sqrt(P)
    cov = A @ A.T + 0.1 * np.eye(P)
    icov = jnp.asarray(np.linalg.inv(cov), jnp.float32)

    def logp(t):
        return -0.5 * t @ icov @ t

    return logp, np.asarray(cov, np.float32)


def forward_model_posterior():
    """A GaussianLikelihood over a linear forward model y = A theta."""
    import jax.numpy as jnp
    from inference_tpu.models import GaussianLikelihood

    rng = np.random.default_rng(7)
    A = jnp.asarray(rng.normal(size=(N_DATA, P)) / np.sqrt(P), jnp.float32)
    theta_true = rng.normal(size=P)
    y = np.asarray(A) @ theta_true + 0.1 * rng.normal(size=N_DATA)

    like = GaussianLikelihood(
        y_data=y, sigma=np.full(N_DATA, 0.1),
        forward_model=lambda t: A @ t,
    )
    return like, None


def flops_per_transition(kind: str) -> float:
    """Model FLOPs per accepted transition per chain."""
    if kind == "gaussian":
        # per leapfrog step: gradient matvec 2P^2 + mass velocity 2P^2;
        # plus 2 logp evals (2P^2 each) and one mass momentum sample cost
        # dropped (O(P^2) once per transition)
        return HMC_STEPS * 4 * P**2 + 2 * 2 * P**2
    # forward-model: gradient = A^T((y - A t)/s^2): two 2*N*P matmuls per
    # leapfrog step; logp = one 2*N*P
    return HMC_STEPS * 2 * (2 * N_DATA * P) + 2 * (2 * N_DATA * P)


def run(kind, logp, inverse_mass, sweep):
    import jax
    import jax.numpy as jnp
    from inference_tpu.parallel import ChainArray

    rng = np.random.default_rng(0)
    fpt = flops_per_transition(kind)
    best = (0.0, 0)
    for n_chains in sweep:
        steps = max(8, (1 << 21) // n_chains)
        starts = rng.normal(0, 0.1, size=(n_chains, P))
        ca = ChainArray(
            "hmc", logp, starts, steps=HMC_STEPS, epsilon=0.1,
            inverse_mass=inverse_mass, seed=1, retry=False,
        )
        ca.advance(steps, store=False)  # warm + adapt epsilon
        t0 = time.perf_counter()
        ca.advance(steps, store=False)
        dt = time.perf_counter() - t0
        # acceptance from a short stored stretch
        ca.advance(16, store=True)
        theta = np.concatenate(ca._history, axis=0)
        accept = float((np.abs(np.diff(theta, axis=0)).max(axis=2) > 0).mean())
        rate = n_chains * steps * accept / dt
        tflops = rate / accept * fpt / 1e12  # attempts carry the flops
        print(
            f"[{kind}] chains={n_chains:6d}: {rate:12.0f} samples/s "
            f"(accept {accept:.2f}), {tflops:7.2f} TFLOP/s",
            flush=True,
        )
        if rate > best[0]:
            best = (rate, n_chains)
    return best


def main():
    sweep = [int(a) for a in sys.argv[1:]] or [256, 1024, 4096, 8192]

    import jax
    import jax.numpy as jnp

    assert float(jnp.ones(8).sum()) == 8.0
    print(f"backend: {jax.default_backend()}", flush=True)

    logp, inv_mass = correlated_gaussian()
    run("gaussian", logp, inv_mass, sweep)

    like, _ = forward_model_posterior()
    run("forward-model", lambda t: like(t), None, sweep)


if __name__ == "__main__":
    main()
