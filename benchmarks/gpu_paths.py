"""Measurements that set the GPU policies and record the plain paths.

    python benchmarks/gpu_paths.py [--only df64,assembly,lml_vjp,cholesky,hmc_trace]

- ``df64``: the float64 df64-tier entry points (``ops/df64.py``) at
  N = 16,384 and 50,048 (50,000 padded to a multiple of 128);
- ``assembly``: the two float32 squared-distance forms of
  ``ops/pairwise.py`` (matmul at HIGHEST, difference) with the exponential
  epilogue, time and max abs error against float64, at N = 8,192 and
  16,384, D = 2 and 8;
- ``lml_vjp``: LML value+gradient at N = 16,384 in float32 with the
  covariance differentiated by autodiff of each form, and by a
  hand-written backward for the difference form;
- ``cholesky``: ``GpRegressor`` LML value+gradient for
  ``cholesky="xla"``, ``"blocked"`` and ``"analytic"`` at N = 2,048,
  8,192 and 16,384, float32 and float64;
- ``hmc_trace``: one short profiler trace of the headline ``ChainArray``
  HMC run: device busy and idle share over the window, and device
  kernels per leapfrog step.

Times are medians of repeated calls ending in ``block_until_ready``, after
one warm-up call. Needs an NVIDIA GPU (exits non-zero without one). Prints
one JSON object per measurement; the trace goes to ``benchmarks/traces/``.
"""

import glob
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DF64_NS = (16384, 50048)
ASSEMBLY_NS = (8192, 16384)
LML_N = 16384
CHOLESKY_NS = (2048, 8192, 16384)
HMC_CHAINS = 65536


def emit(**rec):
    print(json.dumps(rec), flush=True)


def median_time(fn, reps):
    """(median seconds, all seconds, first-call seconds) of ``fn()``."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), times, first


def measure_df64():
    import jax
    import jax.numpy as jnp
    from inference_tpu.ops import df64

    for n in DF64_NS:
        rng = np.random.default_rng(0)
        uh, ul = df64.split_f64(rng.uniform(0, 10, size=(n, 2)))
        uh, ul = jnp.asarray(uh), jnp.asarray(ul)
        v = jnp.asarray(rng.normal(size=n))
        V = jnp.asarray(rng.normal(size=(n, 8)))
        cases = [
            ("sqexp_matvec_df64", lambda: df64.sqexp_matvec_df64(uh, ul, v)),
            ("sqexp_matmat_df64 q=8", lambda: df64.sqexp_matmat_df64(uh, ul, V)),
        ]
        for name, fn in cases:
            med, ts, first = median_time(fn, 5)
            emit(kind="df64", entry=name, n=n, median_s=med, times_s=ts,
                 first_call_s=first)
        if n <= 20480:
            med, ts, first = median_time(lambda: df64.sqexp_entries_df64(uh, ul), 3)
            emit(kind="df64", entry="sqexp_entries_df64", n=n, median_s=med,
                 times_s=ts, first_call_s=first)
            Eh, El = df64.sqexp_entries_df64(uh, ul)
            med, ts, first = median_time(
                lambda: df64.sqexp_stored_matvec_df64(Eh, El, v), 5)
            emit(kind="df64", entry="sqexp_stored_matvec_df64", n=n,
                 median_s=med, times_s=ts, first_call_s=first)
            del Eh, El
        med, ts, first = median_time(lambda: df64.sqexp_entries_f32(uh, ul), 3)
        emit(kind="df64", entry="sqexp_entries_f32", n=n, median_s=med,
             times_s=ts, first_call_s=first)
        E = df64.sqexp_entries_f32(uh, ul)
        med, ts, first = median_time(
            lambda: df64.sqexp_stored_f32_matmat(E, v[:, None]), 5)
        emit(kind="df64", entry="sqexp_stored_f32_matmat q=1", n=n,
             median_s=med, times_s=ts, first_call_s=first)
        del E
        jax.clear_caches()


def measure_assembly():
    import jax
    import jax.numpy as jnp
    from inference_tpu.ops.pairwise import (
        scaled_sq_differences, scaled_sq_distances,
    )

    forms = {"matmul": scaled_sq_distances, "difference": scaled_sq_differences}
    for n in ASSEMBLY_NS:
        for d in (2, 8):
            rng = np.random.default_rng(n + d)
            x = rng.uniform(0, 10, size=(n, d))
            ls = np.full(d, 1.5)
            x32, l32 = jnp.asarray(x, jnp.float32), jnp.asarray(ls, jnp.float32)
            with jax.default_matmul_precision("highest"):
                xd = jnp.asarray(x / ls)
                d2 = sum((xd[:, k, None] - xd[None, :, k]) ** 2 for k in range(d))
                K64 = jnp.exp(-0.5 * d2)
            for name, form in forms.items():
                f = jax.jit(lambda a, l, form=form: jnp.exp(-0.5 * form(a, a, l)))
                med, ts, first = median_time(lambda: f(x32, l32), 10)
                err = float(jnp.abs(f(x32, l32).astype(jnp.float64) - K64).max())
                emit(kind="assembly", form=name, n=n, d=d, median_s=med,
                     times_s=ts, max_abs_err_vs_f64=err)
            del K64, d2


def measure_lml_vjp():
    import jax
    import jax.numpy as jnp
    from jax.scipy.linalg import cho_factor, cho_solve
    from inference_tpu.ops.pairwise import (
        scaled_sq_differences, scaled_sq_distances,
    )

    @jax.custom_vjp
    def diff_custom(u, amp, ls):
        return amp**2 * jnp.exp(-0.5 * scaled_sq_differences(u, u, ls))

    def fwd(u, amp, ls):
        K = diff_custom(u, amp, ls)
        return K, (u, amp, ls, K)

    def bwd(res, Kbar):
        # the hand-written backward the package used to carry: one weighted
        # reduction per length scale, one matmul per position cotangent
        u, amp, ls, K = res
        us = u / ls
        w = K * Kbar
        g_ls = jnp.stack([
            (w * (us[:, k, None] - us[None, :, k]) ** 2).sum()
            for k in range(u.shape[1])
        ]) / ls
        ws = w + w.T  # u appears as both the rows and the columns
        hp = jax.lax.Precision.HIGHEST
        du = -(us * ws.sum(axis=1)[:, None] - jnp.dot(ws, us, precision=hp)) / ls
        return du, 2.0 * w.sum() / amp, g_ls

    diff_custom.defvjp(fwd, bwd)
    assemblies = {
        "difference autodiff": lambda u, a, l: a**2 * jnp.exp(
            -0.5 * scaled_sq_differences(u, u, l)),
        "difference custom VJP": diff_custom,
        "matmul autodiff": lambda u, a, l: a**2 * jnp.exp(
            -0.5 * scaled_sq_distances(u, u, l)),
    }
    n = LML_N
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.uniform(0, 10, size=(n, 2)), jnp.float32)
    y = jnp.asarray(np.sin(np.asarray(x[:, 0])) + rng.normal(0, 0.1, n),
                    jnp.float32)
    for name, assemble in assemblies.items():
        def lml(th, assemble=assemble):
            K = assemble(x, jnp.exp(th[0]), jnp.exp(th[1:])) + 0.01 * jnp.eye(n)
            c = cho_factor(K, lower=True)
            return -0.5 * y @ cho_solve(c, y) - jnp.log(jnp.diag(c[0])).sum()

        f = jax.jit(jax.value_and_grad(lml))
        th = jnp.asarray([0.0, 0.5, 0.5], jnp.float32)
        med, ts, first = median_time(lambda: f(th), 5)
        v, g = f(th)
        emit(kind="lml_vjp", variant=name, n=n, dtype="float32", median_s=med,
             times_s=ts, value=float(v), grad=np.asarray(g).tolist())


def measure_cholesky():
    import jax
    import jax.numpy as jnp
    from inference_tpu.gp import GpRegressor

    theta = np.array([0.0, 0.0, 0.5, 0.5])
    for dtype in ("float32", "float64"):
        for n in CHOLESKY_NS:
            rng = np.random.default_rng(0)
            x = rng.uniform(0, 10, size=(n, 2))
            y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
            for variant in ("xla", "blocked", "analytic"):
                gp = GpRegressor(x, y, y_err=np.full(n, 0.1), hyperpars=theta,
                                 dtype=dtype, cholesky=variant)
                th = jnp.asarray(theta, gp._x_dev.dtype)
                med, ts, first = median_time(lambda: gp._lml_grad(th), 5)
                v, g = gp._lml_grad(th)
                emit(kind="cholesky", variant=variant, n=n, dtype=dtype,
                     median_s=med, times_s=ts, first_call_s=first,
                     value=float(v), grad=np.asarray(g).tolist())
                del gp
            jax.clear_caches()


def measure_hmc_trace():
    import jax
    import jax.numpy as jnp
    from inference_tpu.parallel import ChainArray

    rng = np.random.default_rng(42)
    A = rng.normal(size=(10, 10)) / np.sqrt(10)
    icov = jnp.asarray(np.linalg.inv(A @ A.T + np.eye(10)), jnp.float32)
    starts = np.random.default_rng(0).normal(0, 0.1, size=(HMC_CHAINS, 10))
    ca = ChainArray("hmc", lambda t: -0.5 * t @ icov @ t, starts, steps=50,
                    epsilon=0.25, seed=1, retry=False)
    n = 20
    ca.advance(n, store=False)  # compile and warm
    t0 = time.perf_counter()
    ca.advance(n, store=False)
    untraced = time.perf_counter() - t0
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "traces", "hmc")
    jax.profiler.start_trace(trace_dir)
    t0 = time.perf_counter()
    ca.advance(n, store=False)
    traced = time.perf_counter() - t0
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    emit(kind="hmc_trace", **reduce_trace(path), transitions=n,
         nominal_leapfrog_steps=n * 50, untraced_wall_s=untraced,
         traced_wall_s=traced, chains=HMC_CHAINS)


def reduce_trace(path):
    """Device busy/idle share and kernel count from an ``.xplane.pb``: the
    union of kernel intervals on the GPU planes' stream lines, over the
    span from the first kernel start to the last kernel end."""
    import jax

    pd = jax.profiler.ProfileData.from_file(path)
    lines_seen, intervals = {}, []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines_seen[f"{plane.name} | {line.name}"] = len(events)
            if not line.name.startswith("Stream"):
                continue
            for e in events:
                intervals.append((e.start_ns, e.start_ns + e.duration_ns))
    if not intervals:
        return {"planes": [p.name for p in pd.planes], "lines": lines_seen,
                "kernels": 0}
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = max(e for _, e in intervals) - intervals[0][0]
    return {
        "lines": lines_seen,
        "kernels": len(intervals),
        "device_busy_s": busy * 1e-9,
        "window_s": span * 1e-9,
        "idle_share": 1.0 - busy / span,
    }


MEASUREMENTS = {
    "df64": measure_df64,
    "assembly": measure_assembly,
    "lml_vjp": measure_lml_vjp,
    "cholesky": measure_cholesky,
    "hmc_trace": measure_hmc_trace,
}


def main(argv):
    only = list(MEASUREMENTS)
    if argv[:1] == ["--only"] and len(argv) == 2:
        only = argv[1].split(",")
    elif argv:
        raise SystemExit(f"unknown arguments {argv}")
    from inference_tpu.utils.accelerator import (
        card_identity, device_record, enable_compile_cache, require_gpu,
    )

    devices = require_gpu("gpu_paths")
    enable_compile_cache()
    import jax

    emit(kind="device", card=card_identity(), device=device_record(devices[:1]))
    failed = []
    for name in only:
        # the sampler runs in float32 as users run it; the GP measurements
        # need float64 available
        jax.config.update("jax_enable_x64", name != "hmc_trace")
        try:
            MEASUREMENTS[name]()
        except Exception as e:  # record the failure, go on, exit non-zero
            emit(kind="error", measurement=name, error=f"{type(e).__name__}: {e}")
            failed.append(name)
    if failed:
        raise SystemExit(f"[ gpu_paths ] failed: {', '.join(failed)}")


if __name__ == "__main__":
    main(sys.argv[1:])
