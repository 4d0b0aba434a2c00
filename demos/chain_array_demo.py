"""ChainArray demo: thousands of HMC chains per device — the vectorised
replacement for the reference's ChainPool
(reference: demos/scripts/ChainPool_demo.py)."""

import time
import numpy as np
import jax.numpy as jnp
from inference_tpu.parallel import ChainArray


def main():
    # 10-dim correlated gaussian
    rng = np.random.default_rng(42)
    A = rng.normal(size=(10, 10)) / np.sqrt(10)
    cov = A @ A.T + np.eye(10)
    icov = jnp.asarray(np.linalg.inv(cov))

    def logp(t):
        return -0.5 * t @ icov @ t

    starts = rng.normal(0, 0.1, size=(1000, 10))
    chains = ChainArray("hmc", logp, starts, seed=0)

    chains.advance(32, store=False)  # warm-up / step-size adaptation
    t0 = time.perf_counter()
    chains.advance(256)
    dt = time.perf_counter() - t0
    print(f"1000 chains x 256 steps in {dt:.2f}s "
          f"({1000 * 256 / dt:,.0f} samples/s)")

    sample = chains.get_sample(burn=50)
    emp_cov = np.cov(sample.T)
    err = np.abs(emp_cov - cov).max()
    print(f"pooled sample: {sample.shape}, max |cov error| = {err:.3f}")


if __name__ == "__main__":
    main()
