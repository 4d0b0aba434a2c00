"""End-to-end smoke run of the main paths on an NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded paths only

Each phase drives the public classes at full width and checks its output
against an independent reference, printing what ran, the sizes, the
precision, wall and compile seconds and the error beside its tolerance.
Any failed check makes the script exit non-zero. It exits non-zero before
measuring anything when JAX's default backend is not a GPU. The last line
of standard output is one JSON object naming the device.

Everything runs in this one process (the only child is ``nvidia-smi``):
a JAX process reserves most of a card's memory when it starts.
"""

import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

N_DIM = 10


class PhaseFailure(AssertionError):
    """A phase's output missed its reference."""


@dataclass(frozen=True)
class Sizes:
    hmc_chains: int = 65536
    hmc_burn: int = 200
    hmc_keep: int = 100
    kind_chains: int = 4096
    kind_steps: int = 200
    gp_n: int = 16384
    df64_n: int = 16384
    assembly_ns: tuple = (8192, 16384)
    assembly_ds: tuple = (2, 8)
    tempering_steps: int = 200
    bo_iterations: int = 3
    callback_chains: int = 64
    callback_steps: int = 300
    sharded_gp_n: int = 16384


# small enough for a CPU test run; the phase logic is the same
TINY = Sizes(
    hmc_chains=256, hmc_burn=100, hmc_keep=20, kind_chains=128,
    kind_steps=60, gp_n=256, df64_n=256, assembly_ns=(256,),
    assembly_ds=(2, 8), tempering_steps=40, bo_iterations=1,
    callback_chains=8, callback_steps=200, sharded_gp_n=512,
)


# ------------------------------------------------------------------ #
# shared helpers
# ------------------------------------------------------------------ #
class CompileClock:
    """Seconds JAX spent tracing, lowering and compiling (its own
    monitoring events), so each phase can report compile time apart from
    its wall time."""

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, name, duration, **_):
        if name.startswith("/jax/core/compile/"):
            self.total += duration


def correlated_gaussian(n_dim=N_DIM, seed=42):
    """The 10-dim correlated Gaussian of ``bench.py``: its covariance."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_dim, n_dim)) / np.sqrt(n_dim)
    return A @ A.T + np.eye(n_dim)


def gaussian_logp(cov, dtype):
    import jax.numpy as jnp

    icov = jnp.asarray(np.linalg.inv(cov), dtype)
    return lambda t: -0.5 * t @ icov @ t


def check(cond, message):
    if not cond:
        raise PhaseFailure(message)


def check_moments(samples, cov, label, n_se=6.0):
    """Sample mean and covariance of independent draws against the
    analytic (0, cov), each entry within ``n_se`` standard errors (the
    Gaussian standard errors of a mean and of a covariance entry over
    ``len(samples)`` independent draws; 6 keeps the family-wise false
    alarm below 1e-6 over the 65 entries of a 10-dim Gaussian)."""
    x = np.asarray(samples, np.float64).reshape(-1, cov.shape[0])
    check(np.isfinite(x).all(), f"{label}: non-finite samples")
    k = x.shape[0]
    var = np.diag(cov)
    mean_z = np.abs(x.mean(axis=0)) / np.sqrt(var / k)
    emp = np.cov(x, rowvar=False)
    cov_se = np.sqrt((np.outer(var, var) + cov**2) / k)
    cov_z = np.abs(emp - cov) / cov_se
    worst = max(mean_z.max(), cov_z.max())
    line = (
        f"{label}: moments over {k} independent draws, worst deviation "
        f"{worst:.2f} standard errors <= tol {n_se} (mean max "
        f"{mean_z.max():.2f}, covariance max {cov_z.max():.2f})"
    )
    check(worst <= n_se, line)
    return line


def timed(clock, fn):
    """(result, wall seconds, compile seconds) of ``fn()``."""
    c0, t0 = clock.total, time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0, clock.total - c0


def target_draws(cov, shape, seed):
    """Exact draws from N(0, cov): starting a kernel here, any correct
    kernel keeps the chains' distribution exactly the target, so the
    final states test the transition kernel itself."""
    rng = np.random.default_rng(seed)
    L = np.linalg.cholesky(cov)
    return rng.normal(size=(*shape, cov.shape[0])) @ L.T


# ------------------------------------------------------------------ #
# phase 1: batched HMC, the headline
# ------------------------------------------------------------------ #
def phase_hmc(sizes, clock):
    import jax
    from inference_tpu.parallel import ChainArray
    from inference_tpu.utils import default_float

    dtype = default_float()
    cov = correlated_gaussian()
    K = sizes.hmc_chains
    starts = np.random.default_rng(0).normal(0, 0.1, size=(K, N_DIM))
    ca = ChainArray(
        "hmc", gaussian_logp(cov, dtype), starts, steps=50, epsilon=0.25,
        seed=1, retry=False,
    )
    _, w_burn, c_burn = timed(clock, lambda: ca.advance(sizes.hmc_burn, store=False))
    _, w_keep, c_keep = timed(clock, lambda: ca.advance(sizes.hmc_keep, store=True))
    hist = np.concatenate(ca._history, axis=0)  # (steps, K, P)
    check(np.isfinite(hist).all(), "hmc: non-finite positions")
    moved = (np.abs(np.diff(hist, axis=0)).max(axis=2) > 0).mean()
    check(0.3 < moved < 0.95, f"hmc: acceptance {moved:.3f} outside (0.3, 0.95)")
    lines = [
        f"ChainArray('hmc') {K} chains x {N_DIM} dims, 50 leapfrog steps, "
        f"retry=False, {sizes.hmc_burn} + {sizes.hmc_keep} transitions | "
        f"{np.dtype(dtype).name}, default matmul precision",
        f"burn-in wall {w_burn:.3f} s (compile {c_burn:.3f} s); stored run "
        f"wall {w_keep:.3f} s (compile {c_keep:.3f} s)",
        f"acceptance {moved:.4f} in (0.3, 0.95)",
        check_moments(ca.theta, cov, "hmc final states"),
    ]
    return lines


def hmc_proposals(cov, theta0, keys, dtype, device, precision):
    """One vmapped ``make_hmc_step`` transition whose proposal is always
    accepted: the current log-probability is -inf, so the returned
    position IS the proposal, before any accept test. Momenta are drawn
    in float32 and cast, so every dtype sees the same random numbers."""
    import jax
    import jax.numpy as jnp
    from inference_tpu.mcmc._kernels.hmc import init_hmc_state, make_hmc_step

    with jax.default_device(device), jax.default_matmul_precision(precision):
        logp = gaussian_logp(cov, dtype)
        step = make_hmc_step(
            logp, jax.grad(logp), retry=False,
            mass_sample=lambda k, d: jax.random.normal(
                k, (N_DIM,), jnp.float32
            ).astype(d),
        )
        theta = jax.device_put(jnp.asarray(theta0, dtype), device)
        state = jax.vmap(
            lambda t, k: init_hmc_state(t, -jnp.inf, 0.1, k, steps=50)
        )(theta, jax.device_put(keys, device))
        new_state, out = jax.jit(jax.vmap(step))(state)
        return np.asarray(new_state.theta, np.float64), np.asarray(
            out.leapfrog_steps
        )


def phase_hmc_step(sizes, clock):
    """The float32 device transition against the same transition on the
    CPU in float64 at HIGHEST precision (needs x64 on)."""
    import jax

    cov = correlated_gaussian()
    K = min(sizes.hmc_chains, 4096)
    theta0 = target_draws(cov, (K,), seed=3)
    keys = jax.random.split(jax.random.PRNGKey(7), K)
    dev = jax.devices()[0]
    (got, n_got), wall, comp = timed(
        clock,
        lambda: hmc_proposals(cov, theta0, keys, np.float32, dev, "default"),
    )
    ref, n_ref = hmc_proposals(
        cov, theta0, keys, np.float64, jax.devices("cpu")[0], "highest"
    )
    check(np.array_equal(n_got, n_ref), "hmc step: leapfrog counts differ")
    scale = np.sqrt(np.diag(cov)).max()
    err = np.abs(got - ref).max() / scale
    # 50 leapfrog steps of a float32 integrator whose gradient matvec may
    # run in TF32 (~1e-3 relative per product): the proposal drifts a few
    # 1e-3 of the posterior scale, far below the 1e-1 of a wrong step
    tol = 2e-2
    check(np.isfinite(got).all() and err <= tol,
          f"hmc step: max error {err:.3e} > tol {tol}")
    return [
        f"make_hmc_step proposal, {K} vmapped chains, 50 leapfrog steps | "
        f"device float32 default precision vs CPU float64 HIGHEST",
        f"wall {wall:.3f} s (compile {comp:.3f} s)",
        f"max |proposal - reference| / posterior scale {err:.3e} <= tol "
        f"{tol} (float32 integrator with TF32 products over 50 steps)",
    ]


# ------------------------------------------------------------------ #
# phase 2: every other ChainArray kind, and EnsembleSampler
# ------------------------------------------------------------------ #
def phase_chain_kinds(sizes, clock):
    from inference_tpu.mcmc import EnsembleSampler
    from inference_tpu.parallel import ChainArray
    from inference_tpu.utils import default_float

    dtype = default_float()
    cov = correlated_gaussian()
    logp = gaussian_logp(cov, dtype)
    K, steps = sizes.kind_chains, sizes.kind_steps
    lines = []
    kinds = [
        ("gibbs", dict(widths=1.0), steps),
        ("metropolis", dict(widths=1.0), steps),
        ("pca", dict(widths=1.0), steps),
        ("nuts", dict(epsilon=0.25, max_depth=8), max(steps // 2, 20)),
    ]
    for i, (kind, kw, n) in enumerate(kinds):
        starts = target_draws(cov, (K,), seed=10 + i)
        ca = ChainArray(kind, logp, starts, seed=i, **kw)
        _, wall, comp = timed(clock, lambda: ca.advance(n, store=False))
        end = ca.theta
        moved = (np.abs(end - starts).max(axis=1) > 0).mean()
        check(moved > 0.9, f"{kind}: only {moved:.3f} of chains moved")
        lines.append(
            f"ChainArray('{kind}') {K} chains, {n} steps: wall {wall:.3f} s "
            f"(compile {comp:.3f} s), {moved:.3f} of chains moved; "
            + check_moments(end, cov, kind)
        )
    n_walkers = 2 * N_DIM + 2
    starts = target_draws(cov, (K, n_walkers), seed=20)
    ca = ChainArray("ensemble", logp, starts, seed=5)
    _, wall, comp = timed(clock, lambda: ca.advance(steps, store=False))
    lines.append(
        f"ChainArray('ensemble') {K} chains x {n_walkers} walkers, {steps} "
        f"steps: wall {wall:.3f} s (compile {comp:.3f} s); "
        + check_moments(ca.theta, cov, "ensemble kind")
    )
    starts = target_draws(cov, (K,), seed=21)
    es = EnsembleSampler(
        logp, starting_positions=starts, display_progress=False, seed=1,
        retry=False,
    )

    def run():
        import jax

        es.advance(steps)
        jax.block_until_ready(es._state.walkers)

    _, wall, comp = timed(clock, run)
    lines.append(
        f"EnsembleSampler {K} walkers, {steps} iterations: wall {wall:.3f} s "
        f"(compile {comp:.3f} s); "
        + check_moments(np.asarray(es._state.walkers), cov, "EnsembleSampler")
    )
    return lines


# ------------------------------------------------------------------ #
# phase 3: dense GP marginal likelihood and its gradient
# ------------------------------------------------------------------ #
def gp_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 10, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.1, n)
    return x, y, np.full(n, 0.1)


def reference_lml(theta, x, y, y_err):
    """Plain float64 LML (constant mean, squared-exponential kernel) and
    its gradient: ``cho_factor``/``cho_solve`` and ``jax.grad`` at
    HIGHEST precision, independent of the package."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.linalg import cho_factor, cho_solve

    x, y, s2 = (jnp.asarray(a, jnp.float64) for a in (x, y, y_err**2))

    def lml(th):
        amp2, ls = jnp.exp(2 * th[1]), jnp.exp(th[2:])
        d = (x[:, None, :] - x[None, :, :]) / ls
        K = amp2 * jnp.exp(-0.5 * (d * d).sum(-1)) + jnp.diag(s2)
        c = cho_factor(K, lower=True)
        r = y - th[0]
        return -0.5 * r @ cho_solve(c, r) - jnp.log(jnp.diag(c[0])).sum()

    with jax.default_matmul_precision("highest"):
        v, g = jax.jit(jax.value_and_grad(lml))(jnp.asarray(theta, jnp.float64))
        return float(v), np.asarray(g)


def phase_gp_lml(sizes, clock):
    import jax
    import jax.numpy as jnp
    from inference_tpu.gp import GpRegressor

    n = sizes.gp_n
    theta = np.array([0.0, 0.0, 0.5, 0.5])
    x, y, err = gp_data(n)
    ref_v, ref_g = reference_lml(theta, x, y, err)
    lines = [f"reference: plain float64 cho_factor LML {ref_v:.10e}"]
    # float64 is the reference library's contract; float32 carries the
    # Cholesky's kappa * eps32 loss (kappa ~ n amp^2 / sigma^2 ~ 1e6)
    tols = {"float64": 1e-8, "float32": 1e-2}
    for dt, tol in tols.items():
        gp = GpRegressor(x, y, y_err=err, hyperpars=theta, dtype=dt)
        (v, g), wall, comp = timed(
            clock, lambda: gp.marginal_likelihood_gradient(theta)
        )
        _, wall2, _ = timed(clock, lambda: gp.marginal_likelihood_gradient(theta))
        e_v = abs(v - ref_v) / abs(ref_v)
        e_g = np.abs(g - ref_g).max() / np.abs(ref_g).max()
        line = (
            f"GpRegressor N={n} D=2 {dt} LML+grad: first call {wall:.3f} s "
            f"(compile {comp:.3f} s), repeat {wall2:.4f} s | rel err value "
            f"{e_v:.3e}, gradient {e_g:.3e} <= tol {tol:g}"
        )
        check(np.isfinite(v) and np.isfinite(g).all(), f"{dt}: non-finite")
        check(e_v <= tol and e_g <= tol, line)
        lines.append(line)
        data = (gp._x_dev, gp._y_dev, gp._sig_dev, gp._mask_dev)
        compiled = (
            jax.jit(jax.value_and_grad(gp._lml_raw))
            .lower(jnp.asarray(theta, gp._x_dev.dtype), *data)
            .compile()
        )
        lines.append(f"{dt} gradient program memory: {compiled.memory_analysis()}")
        del gp, compiled
    return lines


# ------------------------------------------------------------------ #
# phase 4: large-scale GP, the df64 tier
# ------------------------------------------------------------------ #
def phase_df64(sizes, clock):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from inference_tpu.gp import LargeScaleGP
    from inference_tpu.ops import df64

    # each entry point against a plain float64 evaluation of E = exp(-d2/2)
    n = sizes.df64_n
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, size=(n, 2))
    uh, ul = df64.split_f64(x[: n - n % 128] / 0.9)
    m = uh.shape[0]
    u = jnp.asarray(uh, jnp.float64) + jnp.asarray(ul, jnp.float64)
    V = jnp.asarray(np.random.default_rng(1).normal(size=(m, 4)))
    with jax.default_matmul_precision("highest"):
        E = jnp.exp(-0.5 * ((u[:, None, :] - u[None, :, :]) ** 2).sum(-1))
        EV = E @ V
    scale = float(jnp.abs(EV).max())
    uh_d, ul_d = jnp.asarray(uh), jnp.asarray(ul)
    mesh1 = Mesh(np.array(jax.devices()[:1]), ("rows",))
    Eh, El = df64.sqexp_entries_df64(uh_d, ul_d)
    E32 = df64.sqexp_entries_f32(uh_d, ul_d)
    lines = []
    cases = {
        "sqexp_matvec_df64": (
            lambda: df64.sqexp_matvec_df64(uh_d, ul_d, V[:, 0]), EV[:, 0]),
        "sqexp_matmat_df64": (
            lambda: df64.sqexp_matmat_df64(uh_d, ul_d, V), EV),
        "sqexp_matmat_rect_df64": (
            lambda: df64.sqexp_matmat_rect_df64(
                uh_d[:128], ul_d[:128], uh_d, ul_d, V), EV[:128]),
        "sqexp_matmat_df64_sharded": (
            lambda: df64.sqexp_matmat_df64_sharded(uh_d, ul_d, V, mesh1), EV),
        "sqexp_stored_matmat_df64": (
            lambda: df64.sqexp_stored_matmat_df64(Eh, El, V), EV),
        "sqexp_stored_matvec_df64": (
            lambda: df64.sqexp_stored_matvec_df64(Eh, El, V[:, 0]), EV[:, 0]),
    }
    # float64 against float64: only the summation order differs (n terms
    # of eps64 each, ~n * 1.1e-16 relative at worst)
    tol = max(1e-11, 4 * m * 1.1e-16)
    for name, (fn, want) in cases.items():
        got, wall, comp = timed(clock, lambda: jax.block_until_ready(fn()))
        err = float(jnp.abs(got - want).max()) / scale
        line = (
            f"{name} N={m}: {wall:.4f} s (compile {comp:.3f} s) | float64 "
            f"rel err {err:.3e} <= tol {tol:.1e}"
        )
        check(err <= tol, line)
        lines.append(line)
    err_pair = float(jnp.abs(Eh.astype(jnp.float64) + El - E).max())
    err_f32 = float(jnp.abs(E32.astype(jnp.float64) - E).max())
    err_stored = float(
        jnp.abs(df64.sqexp_stored_f32_matmat(E32, V)
                - E32.astype(jnp.float64) @ V).max()
    ) / scale
    for name, err, tol, why in (
        ("sqexp_entries_df64", err_pair, 1e-14, "pair keeps ~2^-48"),
        ("sqexp_entries_f32", err_f32, 6e-8, "one rounding to float32"),
        ("sqexp_stored_f32_matmat", err_stored, tol, "float64 contraction"),
    ):
        line = f"{name} N={m}: max err {err:.3e} <= tol {tol:.1e} ({why})"
        check(err <= tol, line)
        lines.append(line)
    del E, Eh, El, E32
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.01, n)
    gp, wall, comp = timed(clock, lambda: LargeScaleGP(
        x, y, np.full(n, 0.01), hyperpars=np.array([0.0, 0.0, 0.0]),
        block_size=min(4096, n), preconditioner_rank=min(512, n // 2),
        solver="df64", cg_tol=1e-9, cg_maxiter=3000, dtype="float32",
        store_entries=True,
    ))
    res = gp.residual_norm_f64()
    del gp
    line = (
        f"LargeScaleGP(solver='df64', store_entries=True) N={n} sigma=0.01: "
        f"constructor + solve {wall:.3f} s (compile {comp:.3f} s) | float64 "
        f"residual {res:.3e} <= tol 1e-9"
    )
    check(res <= 1e-9, line)
    lines.append(line)
    return lines


# ------------------------------------------------------------------ #
# phase 5: covariance assembly
# ------------------------------------------------------------------ #
def phase_assembly(sizes, clock):
    import jax
    import jax.numpy as jnp
    from inference_tpu.ops.pairwise import sqexp_covariance

    lines = []
    for n in sizes.assembly_ns:
        for d in sizes.assembly_ds:
            rng = np.random.default_rng(n + d)
            x = rng.uniform(0, 10, size=(n, d))
            ls = np.full(d, 1.5)
            f = jax.jit(sqexp_covariance)
            x32, l32 = jnp.asarray(x, jnp.float32), jnp.asarray(ls, jnp.float32)
            K32, wall, comp = timed(
                clock, lambda: jax.block_until_ready(f(x32, x32, 1.0, l32))
            )
            _, wall2, _ = timed(
                clock, lambda: jax.block_until_ready(f(x32, x32, 1.0, l32))
            )
            with jax.default_matmul_precision("highest"):
                xd = jnp.asarray(x / ls, jnp.float64)
                d2 = sum((xd[:, k, None] - xd[None, :, k]) ** 2 for k in range(d))
                err = float(jnp.abs(K32.astype(jnp.float64) - jnp.exp(-0.5 * d2)).max())
            # float32 rounding of the scaled differences and of exp: a few
            # ulps of entries that are at most 1
            tol = 1e-5
            line = (
                f"sqexp_covariance float32 N={n} D={d}: first call {wall:.4f} s "
                f"(compile {comp:.3f} s), repeat {wall2:.5f} s | max abs err vs "
                f"float64 {err:.3e} <= tol {tol:g}"
            )
            check(err <= tol, line)
            lines.append(line)
            del K32
    return lines


# ------------------------------------------------------------------ #
# phases 6-8: host-driven paths
# ------------------------------------------------------------------ #
def phase_bo(sizes, clock):
    """Bayesian optimisation: the host loop around device fits."""
    from inference_tpu.gp import GpOptimiser

    def objective(x):
        x = np.atleast_2d(x)
        return float(
            -np.sum((x[0] - 3.14) ** 2)
            + np.sin(3.0 * x[0, 0]) * np.cos(2.0 * x[0, 1])
        )

    rng = np.random.default_rng(0)
    x0 = rng.uniform(0, 6, size=(6, 2))
    opt = GpOptimiser(
        x0, np.array([objective(p) for p in x0]),
        bounds=[(0.0, 6.0), (0.0, 6.0)], optimizer="device",
    )

    def iterate():
        for _ in range(sizes.bo_iterations):
            xq = opt.propose_evaluation()
            xa = np.atleast_1d(xq)
            check(np.isfinite(xa).all() and np.all((xa >= 0) & (xa <= 6)),
                  f"GpOptimiser proposal {xq} outside the bounds")
            opt.add_evaluation(xq, objective(xq))

    _, wall, comp = timed(clock, iterate)
    best = float(np.max(opt.y))
    check(np.isfinite(best), "GpOptimiser: non-finite objective record")
    return [
        f"GpOptimiser(optimizer='device') {sizes.bo_iterations} iterations: "
        f"wall {wall:.3f} s (compile {comp:.3f} s), proposals inside the "
        f"bounds, best {best:.4f}"
    ]


def phase_tempering(sizes, clock):
    """Replica exchange over 8 rungs of GibbsChain, swaps on the device."""
    import jax.numpy as jnp
    from inference_tpu.mcmc import GibbsChain, ParallelTempering

    def bimodal(t):
        x = t[0]
        return jnp.logaddexp(
            -0.5 * ((x + 4.0) / 0.5) ** 2, -0.5 * ((x - 4.0) / 0.5) ** 2
        )

    temps = [2.0**k for k in range(8)]
    chains = [
        GibbsChain(bimodal, start=np.array([4.0]), widths=np.array([0.3]),
                   temperature=T, display_progress=False, seed=i)
        for i, T in enumerate(temps)
    ]
    pt = ParallelTempering(chains)
    _, wall, comp = timed(
        clock, lambda: pt.advance(sizes.tempering_steps, swap_interval=10)
    )
    pt.shutdown()
    cold = np.asarray(chains[0].get_sample())
    swaps = pt.successful_swaps.sum() / max(pt.attempted_swaps.sum(), 1)
    check(np.isfinite(cold).all(), "tempering: non-finite samples")
    check(0.0 < swaps <= 1.0, f"tempering: swap acceptance {swaps}")
    return [
        f"ParallelTempering 8 GibbsChain rungs, {sizes.tempering_steps} "
        f"steps: wall {wall:.3f} s (compile {comp:.3f} s), swap acceptance "
        f"{swaps:.3f}, cold-chain samples finite"
    ]


def phase_host_callback(sizes, clock):
    """A numpy-only posterior, evaluated on the host through
    ``pure_callback`` inside the compiled ChainArray loop."""
    from inference_tpu.parallel import ChainArray

    def np_posterior(t):
        return float(-0.5 * np.sum(np.asarray(t) ** 2))

    K = sizes.callback_chains
    ca = ChainArray(
        "metropolis", np_posterior,
        target_draws(np.eye(2), (K,), seed=30), widths=1.0, seed=3,
    )
    _, wall, comp = timed(clock, lambda: ca.advance(sizes.callback_steps))
    hist = np.concatenate(ca._history, axis=0)[sizes.callback_steps // 2:]
    mean_err = np.abs(hist.reshape(-1, 2).mean(axis=0)).max()
    # chains start at exact draws; over the second half the pooled mean of
    # a unit Gaussian has standard error ~ (autocorrelation time / draws)^0.5
    tol = 0.25
    line = (
        f"ChainArray('metropolis') numpy posterior via pure_callback, {K} "
        f"chains x {sizes.callback_steps} steps: wall {wall:.3f} s (compile "
        f"{comp:.3f} s) | pooled mean max |err| {mean_err:.3f} <= tol {tol}"
    )
    check(np.isfinite(hist).all() and mean_err <= tol, line)
    return [line]


PHASES = [
    ("hmc", phase_hmc, False),
    ("chain_kinds", phase_chain_kinds, False),
    ("hmc_step", phase_hmc_step, True),
    ("gp_lml", phase_gp_lml, True),
    ("df64", phase_df64, True),
    ("assembly", phase_assembly, True),
    ("bo", phase_bo, True),
    ("tempering", phase_tempering, True),
    ("host_callback", phase_host_callback, True),
]


# ------------------------------------------------------------------ #
# --four-cards: the paths that span devices
# ------------------------------------------------------------------ #
def phase_sharded_hmc(sizes, clock):
    from inference_tpu.parallel import ChainArray, chain_mesh
    from inference_tpu.utils import default_float

    cov = correlated_gaussian()
    logp = gaussian_logp(cov, default_float())
    K = sizes.hmc_chains
    starts = target_draws(cov, (K,), seed=40)
    mesh = chain_mesh(4)
    runs = {}
    for label, m in (("4 cards", mesh), ("1 card", None)):
        ca = ChainArray("hmc", logp, starts, steps=50, epsilon=0.25, seed=1,
                        retry=False, mesh=m)
        _, wall, comp = timed(clock, lambda: ca.advance(5, store=False))
        runs[label] = (ca.theta, wall, comp, ca._state.theta.sharding)
    devs = runs["4 cards"][3].device_set
    check(len(devs) == 4, f"sharded hmc: state on {len(devs)} devices, not 4")
    a, b = runs["4 cards"][0], runs["1 card"][0]
    agree = (np.abs(a - b).max(axis=1) <= 1e-3).mean()
    # rounding differs between the partitioned and the single-card program;
    # a proposal near its accept threshold can flip, after which that
    # chain's path differs — so agreement is asked of 99% of chains
    check(agree >= 0.99, f"sharded hmc: only {agree:.4f} of chains agree")
    return [
        f"ChainArray('hmc', mesh=chain_mesh(4)) {K} chains, 5 transitions: "
        f"wall {runs['4 cards'][1]:.3f} s (compile {runs['4 cards'][2]:.3f} s) "
        f"vs one card {runs['1 card'][1]:.3f} s | state on {len(devs)} devices, "
        f"{agree:.5f} of chains within 1e-3 of the one-card run >= 0.99",
        check_moments(a, cov, "sharded hmc final states"),
    ]


def phase_sharded_tempering(sizes, clock):
    import jax
    from jax.sharding import Mesh
    from inference_tpu.parallel import ShardedTempering, tempering_mesh
    from inference_tpu.parallel.multihost import global_tempering_mesh
    from inference_tpu.utils import default_float

    cov = correlated_gaussian(4)
    logp = gaussian_logp(cov, default_float())
    temps = np.geomspace(1.0, 8.0, 4)
    meshes = {
        "4 cards": tempering_mesh(n_rungs=4, n_devices=4),
        "4 CPU devices": Mesh(
            np.array(jax.devices("cpu")[:4]).reshape(4, 1), ("rungs", "chains")
        ),
    }
    out = {}
    # full float32 products on both backends: a TF32 gradient (the GPU's
    # default) moves a trajectory by ~1e-3, which would hide the sharding
    # under the precision difference
    for label, mesh in meshes.items():
        with jax.default_matmul_precision("highest"):
            st = ShardedTempering(
                posterior=logp, start=np.zeros(4), temperatures=temps,
                n_chains=256, mesh=mesh, steps=10, epsilon=0.2, seed=0,
                display_progress=False,
            )
            acc, wall, comp = timed(
                clock, lambda: st.advance(20, swap_interval=5)
            )
        out[label] = (st.theta, np.asarray(acc), wall, comp, st)
    st4 = out["4 cards"][4]
    devs = {d for leaf in jax.tree.leaves(st4._state) for d in leaf.sharding.device_set}
    check(len(devs) == 4, f"tempering: state on {len(devs)} devices, not 4")
    g_mesh = global_tempering_mesh(4)
    n_all = len(jax.devices())
    check(len(set(g_mesh.devices.flat)) == n_all,
          f"global_tempering_mesh does not span all {n_all} devices")
    a, b = out["4 cards"][0], out["4 CPU devices"][0]
    check(np.isfinite(a).all(), "tempering: non-finite positions")
    agree = (np.abs(a - b).max(axis=-1) <= 1e-3).mean()
    swap_agree = (out["4 cards"][1] == out["4 CPU devices"][1]).mean()
    # float32 on two backends: summation order differs, and an accept
    # decision near its threshold can flip, after which that chain's path
    # differs
    check(agree >= 0.95, f"tempering: only {agree:.4f} of chains agree")
    return [
        f"ShardedTempering tempering_mesh(n_rungs=4) x 256 chains, 20 steps, "
        f"swaps every 5: wall {out['4 cards'][2]:.3f} s (compile "
        f"{out['4 cards'][3]:.3f} s) | state on {len(devs)} devices; "
        f"global_tempering_mesh(4) spans {len(set(g_mesh.devices.flat))}",
        f"vs the same program on 4 CPU devices, both at HIGHEST matmul "
        f"precision: {agree:.4f} of chains within 1e-3 (>= 0.95), swap "
        f"decisions equal {swap_agree:.4f}",
    ]


def phase_sharded_gp(sizes, clock):
    from inference_tpu.gp import LargeScaleGP
    from inference_tpu.parallel import chain_mesh

    n = sizes.sharded_gp_n
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 10, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.01, n)
    q = rng.uniform(0, 10, size=(64, 2))
    out = {}
    for label, mesh in (("4 cards", chain_mesh(4)), ("1 card", None)):
        gp, wall, comp = timed(clock, lambda: LargeScaleGP(
            x, y, np.full(n, 0.01), hyperpars=np.array([0.0, 0.0, 0.0]),
            block_size=min(4096, n // 4), preconditioner_rank=min(512, n // 4),
            solver="df64", cg_tol=1e-9, cg_maxiter=3000, dtype="float32",
            store_entries=False, mesh=mesh,
        ))
        out[label] = (gp.residual_norm_f64(), np.asarray(gp(q)), wall, comp)
    r4, r1 = out["4 cards"][0], out["1 card"][0]
    diff = np.abs(out["4 cards"][1] - out["1 card"][1]).max()
    scale = np.abs(out["1 card"][1]).max()
    # both solves reach a 1e-9 residual; their predictions then agree far
    # below the data noise (0.01)
    tol = 1e-6 * max(scale, 1.0)
    line = (
        f"LargeScaleGP(solver='df64', mesh=chain_mesh(4)) N={n}: wall "
        f"{out['4 cards'][2]:.3f} s (compile {out['4 cards'][3]:.3f} s) vs one "
        f"card {out['1 card'][2]:.3f} s | residuals {r4:.2e} / {r1:.2e} <= 1e-9, "
        f"prediction max diff {diff:.2e} <= tol {tol:.1e}"
    )
    check(r4 <= 1e-9 and r1 <= 1e-9 and diff <= tol, line)
    return [line]


def phase_dryrun(sizes, clock):
    import io
    from contextlib import redirect_stdout

    import __graft_entry__

    buf = io.StringIO()
    with redirect_stdout(buf):
        _, wall, comp = timed(clock, lambda: __graft_entry__.dryrun_multichip(4))
    return [f"__graft_entry__.dryrun_multichip(4): wall {wall:.3f} s "
            f"(compile {comp:.3f} s)"] + buf.getvalue().strip().splitlines()


FOUR_CARD_PHASES = [
    ("sharded_hmc", phase_sharded_hmc, False),
    ("sharded_tempering", phase_sharded_tempering, False),
    ("sharded_gp", phase_sharded_gp, True),
    ("dryrun_multichip", phase_dryrun, True),
]


def run_phases(phases, sizes, clock, log=print):
    """Run ``phases`` in order (enabling x64 before the first phase that
    needs it); returns the names of the phases that failed."""
    import jax

    failed = []
    for name, fn, needs_x64 in phases:
        if needs_x64:
            jax.config.update("jax_enable_x64", True)
        t0 = time.perf_counter()
        try:
            lines = fn(sizes, clock)
            status = "ok"
        except Exception as e:  # a failed phase is reported, then counted
            lines = [f"{type(e).__name__}: {e}"]
            status = "FAILED"
            failed.append(name)
        log(f"[phase {name}] {status} in {time.perf_counter() - t0:.1f} s")
        for line in lines:
            log(f"  {line}")
        sys.stdout.flush()
    return failed


def main(argv):
    four = "--four-cards" in argv
    unknown = [a for a in argv if a != "--four-cards"]
    if unknown:
        raise SystemExit(f"unknown arguments {unknown}")
    if four:
        # the tempering comparison runs the same program on 4 virtual CPU
        # devices in this process; the flag must precede JAX's start
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + " --xla_force_host_platform_device_count=4"
        )
    import jax
    from inference_tpu.utils.accelerator import (
        card_identity, device_record, enable_compile_cache, require_gpu,
    )

    devices = require_gpu("chip_smoke")
    cache = enable_compile_cache()
    want = 4 if four else 1
    if len(devices) < want:
        raise SystemExit(f"[ chip_smoke ] needs {want} GPUs, found {len(devices)}")
    print(f"card (nvidia-smi name, power.limit): {card_identity()}")
    print(f"jax {jax.__version__}, device_kind {devices[0].device_kind}, "
          f"{len(devices)} device(s), compile cache {cache}")
    clock = CompileClock()
    phases = FOUR_CARD_PHASES if four else PHASES
    failed = run_phases(phases, Sizes(), clock)
    if failed:
        raise SystemExit(f"[ chip_smoke ] failed phases: {', '.join(failed)}")
    record = device_record(devices[:want])
    print(json.dumps({"ok": True, "device": record}))


if __name__ == "__main__":
    main(sys.argv[1:])
