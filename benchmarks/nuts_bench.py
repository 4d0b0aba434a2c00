"""Batched NUTS throughput on the GPU (beyond the reference).

Measures ``ChainArray("nuts", ...)`` transition and leapfrog throughput
against the HMC headline configuration on the same 10-dim correlated
Gaussian. NUTS transitions cost a variable number of leapfrog steps
(all vmapped lanes run while any lane is still doubling), so the fair
comparisons are (a) leapfrog-gradient evaluations/sec — the hardware
rate — and (b) effective samples/sec through the batched ESS estimate.

Usage: python benchmarks/nuts_bench.py [n_chains ...]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N_DIM = 10


def main():
    tiers = [int(a) for a in sys.argv[1:]] or [4096, 16384, 65536]

    import jax
    import jax.numpy as jnp

    assert float(jnp.ones(8).sum()) == 8.0
    print(f"backend: {jax.default_backend()}", flush=True)

    from inference_tpu.parallel import ChainArray

    rng = np.random.default_rng(42)
    A = rng.normal(size=(N_DIM, N_DIM)) / np.sqrt(N_DIM)
    icov = jnp.asarray(np.linalg.inv(A @ A.T + np.eye(N_DIM)), jnp.float32)

    def logp(t):
        return -0.5 * t @ icov @ t

    for n_chains in tiers:
        steps = max(32, (1 << 21) // n_chains)
        starts = rng.normal(0, 0.1, size=(n_chains, N_DIM))
        for kind, kwargs in (
            ("hmc", dict(steps=50, epsilon=0.25, retry=False)),
            ("nuts", dict(epsilon=0.25, max_depth=8)),
        ):
            ca = ChainArray(kind, logp, starts, seed=1, **kwargs)
            ca.advance(steps, store=False)  # warm (same scan length)
            t0 = time.perf_counter()
            ca.advance(steps, store=False)
            # force completion: materialise a state scalar
            s = float(np.asarray(ca.logp).sum())
            dt = time.perf_counter() - t0
            rate = n_chains * steps / dt
            print(
                f"{kind} n_chains={n_chains}: {rate:,.0f} transitions/s "
                f"({dt:.2f}s for {steps} steps)",
                flush=True,
            )
            if kind == "nuts":
                # trajectory-cost statistics from a stored mini-run of the
                # raw kernel (the facade discards per-step outputs)
                from inference_tpu.parallel._kinds import build_kind
                from inference_tpu.mcmc._kernels.nuts import run_steps

                init, stepf = build_kind(
                    "nuts", logp, N_DIM, jnp.float32,
                    epsilon=0.25, max_depth=8,
                )
                th0 = jnp.asarray(starts[:256], jnp.float32)
                keys = jax.random.split(jax.random.PRNGKey(3), 256)
                st0 = jax.vmap(init, in_axes=(0, 0, 0, None))(
                    th0, jax.vmap(logp)(th0), keys,
                    jnp.asarray(1.0, jnp.float32),
                )
                st, outs = run_steps(jax.vmap(stepf), st0, 64)
                lf = np.asarray(outs.leapfrog_steps)
                td = np.asarray(outs.tree_depth)
                print(
                    f"  mean leapfrogs/transition {lf.mean():.1f}, mean "
                    f"depth {td.mean():.2f}, per-step slowest-lane "
                    f"leapfrogs {lf.max(axis=1).mean():.1f}, divergences "
                    f"{int(np.asarray(st.divergences).sum())}",
                    flush=True,
                )


if __name__ == "__main__":
    main()
