"""Blocked vs XLA Cholesky on the GPU.

The GP LML+gradient flagship is Cholesky-bound: BENCH_NOTES measures the
N=16,384 eval at ~11% of the f32-HIGHEST ceiling, with XLA's sequential
Cholesky expander the suspected gap. ``ops/linalg.py::blocked_cholesky``
re-expresses the O(N^3) trailing work as statically-unrolled
HIGHEST-precision matmuls. This measures forward and value+gradient
times for both, plus reconstruction accuracy.

Usage: python benchmarks/cholesky_bench.py [N ...]
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    sizes = [int(a) for a in sys.argv[1:]] or [8192, 16384]

    import jax
    import jax.numpy as jnp

    assert float(jnp.ones(8).sum()) == 8.0
    print(f"backend: {jax.default_backend()}", flush=True)

    from inference_tpu.ops.linalg import blocked_cholesky

    def timed(f, *args, reps=3):
        out = f(*args)
        float(jnp.sum(out[..., -1]))  # force materialisation
        t0 = time.perf_counter()
        for _ in range(reps):
            out = f(*args)
        float(jnp.sum(out[..., -1]))
        return (time.perf_counter() - t0) / reps, out

    for n in sizes:
        rng = np.random.default_rng(0)
        x = rng.uniform(0, 10, size=(n, 2)).astype(np.float32)
        flops = n**3 / 3

        @jax.jit
        def assemble(x):
            d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
            K = jnp.exp(-0.5 * d2)
            idx = jnp.arange(n)
            return K.at[idx, idx].add(1e-2)

        K = assemble(jnp.asarray(x))
        float(K[-1, -1])

        t_xla, L0 = timed(jax.jit(jnp.linalg.cholesky), K)
        r0 = float(jnp.abs(L0 @ L0.T - K).max())
        print(
            f"N={n} XLA cholesky: {t_xla*1e3:.0f} ms "
            f"({flops/t_xla/1e12:.2f} TFLOP/s), recon err {r0:.2e}",
            flush=True,
        )

        for block in (1024, 2048, 4096):
            for method in ("inv", "trsm"):
                try:
                    f = jax.jit(
                        lambda K, b=block, m=method: blocked_cholesky(
                            K, block=b, method=m
                        )
                    )
                    t, L = timed(f, K)
                    err = float(jnp.abs(L @ L.T - K).max())
                    print(
                        f"N={n} blocked({block},{method}): {t*1e3:.0f} ms "
                        f"({flops/t/1e12:.2f} TFLOP/s, {t_xla/t:.2f}x), "
                        f"recon err {err:.2e}",
                        flush=True,
                    )
                except Exception as e:
                    print(
                        f"N={n} blocked({block},{method}) FAILED: "
                        f"{type(e).__name__}: {str(e)[:160]}",
                        flush=True,
                    )

        # value+gradient of a logdet objective (the LML shape): the
        # cholesky VJP dominates the flagship's backward pass
        y = jnp.asarray(rng.normal(size=n).astype(np.float32))

        def lml(K, chol):
            L = chol(K)
            a = jax.scipy.linalg.cho_solve((L, True), y)
            return -0.5 * y @ a - jnp.sum(jnp.log(jnp.diag(L)))

        for name, chol in [
            ("xla", jnp.linalg.cholesky),
            ("blocked", lambda K: blocked_cholesky(K, block=2048)),
        ]:
            try:
                f = jax.jit(jax.value_and_grad(lambda K: lml(K, chol)))
                t, g = timed(lambda K: f(K)[1], K, reps=2)
                print(
                    f"N={n} value+grad[{name}]: {t*1e3:.0f} ms "
                    f"({3*flops/t/1e12:.2f} TFLOP/s est)",
                    flush=True,
                )
            except Exception as e:
                print(
                    f"N={n} value+grad[{name}] FAILED: "
                    f"{type(e).__name__}: {str(e)[:160]}",
                    flush=True,
                )


if __name__ == "__main__":
    main()
