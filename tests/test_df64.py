"""The df64 covariance tier (float64 entries over float32-pair inputs)
and the conjugate-gradient solvers that use it."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from inference_tpu.ops.df64 import split_f64, sqexp_matvec_df64


def _pair64(h, l):
    return np.asarray(h, np.float64) + np.asarray(l, np.float64)


def test_sqexp_matvec_df64_matches_host():
    """The matvec vs the float64 host truth: far below the plain-f32
    entry-noise floor (~1e-7 at this N)."""
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("requires x64")
    rng = np.random.default_rng(2)
    n, d = 512, 2
    x = rng.uniform(0, 10, size=(n, d))
    v = rng.normal(size=n) * 1e4
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(axis=2)
    truth = np.exp(-0.5 * d2) @ v

    uh, ul = split_f64(x)
    y = sqexp_matvec_df64(uh, ul, v.astype(np.float32))
    err = np.abs(np.asarray(y) - truth).max() / np.abs(truth).max()
    assert err < 1e-7


def test_sqexp_matvec_df64_validates_padding():
    uh = np.zeros((100, 2), np.float32)
    with pytest.raises(ValueError):
        sqexp_matvec_df64(uh, uh, np.zeros(100, np.float32))


def test_df64_pcg_ill_conditioned():
    """df64_pcg converges to ~1e-11 residuals on a kappa ~ 1e6 SPD system
    given an accurate matvec — far beyond any float32 CG floor. Also
    guards the direction-handling asymmetry: the search direction must be
    KEPT across true-residual refreshes here (a steepest-descent reset —
    correct for mixed_pcg's noisy f32 matvec — wrecks this solver:
    measured floor 5e-7 vs 1e-11 on this very system)."""
    from inference_tpu.ops.solvers import df64_pcg

    if not jax.config.read("jax_enable_x64"):
        pytest.skip("requires x64")
    rng = np.random.default_rng(0)
    n = 300
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (Q * np.logspace(0, 6, n)) @ Q.T
    x_true = rng.normal(size=n)
    b = A @ x_true
    A_dev = jnp.asarray(A)

    def matvec64(v32):
        return A_dev @ v32.astype(jnp.float64)

    x, info = df64_pcg(
        matvec64, jnp.asarray(b), tol=1e-11, maxiter=20000, restart_every=50
    )
    res = np.linalg.norm(b - A @ np.asarray(x)) / np.linalg.norm(b)
    assert res < 1e-10
    assert int(info) == 0


def test_pcg_multi_matches_individual_solves():
    """The batched multi-RHS PCG converges every column to the same
    solution as independent solves, with masked freezing of converged
    columns (columns of very different conditioning)."""
    from inference_tpu.ops.solvers import pcg_multi

    rng = np.random.default_rng(3)
    n, q = 200, 5
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (Q * np.logspace(0, 4, n)) @ Q.T
    X_true = rng.normal(size=(n, q)) * np.logspace(0, 3, q)[None, :]
    B = A @ X_true
    A_dev = jnp.asarray(A, jnp.float64)

    X, info = pcg_multi(
        lambda V: A_dev @ V, jnp.asarray(B), tol=1e-10, maxiter=2000
    )
    res = np.linalg.norm(B - A @ np.asarray(X), axis=0) / np.linalg.norm(
        B, axis=0
    )
    assert res.max() < 1e-9


def test_pcg_multi_matches_mixed_pcg_at_high_condition():
    """Float32 CG with f32 scalar recurrences 'converges' to garbage at
    condition numbers >= 1e6 (the recursive residual drifts from the
    true one) — the small-noise GP posterior-variance regime. pcg_multi
    must carry the same defences as the battle-tested single-RHS
    mixed_pcg (float64 per-column scalars, periodic true-residual
    refresh with a steepest-descent direction reset): on a kappa = 1e6
    SPD system each pcg_multi column must land exactly where mixed_pcg
    lands on the same right-hand side."""
    from inference_tpu.ops.solvers import mixed_pcg, pcg_multi

    rng = np.random.default_rng(5)
    n, q = 384, 3
    # SPD with spectrum spanning 1e6
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    lam = np.logspace(0, 6, n)
    A = (Q * lam) @ Q.T
    A32 = jnp.asarray(A, jnp.float32)
    B = jnp.asarray(rng.normal(size=(n, q)), jnp.float32)

    def true_rel(x, b):
        r = A @ np.asarray(x, np.float64) - np.asarray(b, np.float64)
        return np.linalg.norm(r) / np.linalg.norm(np.asarray(b, np.float64))

    X, _ = pcg_multi(lambda V: A32 @ V, B, tol=1e-6, maxiter=800)
    assert np.isfinite(np.asarray(X)).all()
    # CG at kappa = 1e6 is chaotically sensitive to rounding, so bitwise
    # equality between the batched and single-RHS implementations is not
    # expected — but each column must land at the same f32-matvec noise
    # floor mixed_pcg reaches, never at the old pure-f32 recurrence's
    # garbage (which drifts far past the mixed_pcg floor)
    for k in range(q):
        xk, _ = mixed_pcg(lambda v: A32 @ v, B[:, k], tol=1e-6, maxiter=800)
        assert true_rel(X[:, k], B[:, k]) < 1.5 * true_rel(xk, B[:, k]) + 1e-6


def test_df64_solver_breakdown_freezes_iterate():
    """Once pAp <= 0 (impossible for SPD A in exact arithmetic — a
    precision breakdown), every later update in the chunk must freeze:
    the returned iterate is never made WORSE than the point of
    breakdown by continuing to update along corrupt directions."""
    from inference_tpu.ops.solvers import Df64Solver

    rng = np.random.default_rng(7)
    n = 128
    # indefinite diagonal: CG's pAp goes negative once the iteration
    # mixes in the negative eigendirections
    d = np.ones(n)
    d[-8:] = -0.5
    b = rng.normal(size=n)

    def matvec64(v32):
        return (jnp.asarray(d) * v32.astype(jnp.float64))

    solver = Df64Solver(matvec64, restart_every=25)
    x, info = solver.solve(jnp.asarray(b), tol=1e-12, maxiter=100)
    r = b - d * np.asarray(x)
    # never worse than the starting residual ||b||
    assert np.linalg.norm(r) <= np.linalg.norm(b) * (1.0 + 1e-6)
    assert int(info) != 0  # breakdown reported, not claimed converged


def test_sqexp_matmat_df64_matches_matvec_columns():
    """The multi-RHS matmat evaluates the same entries as the matvec —
    columns must agree with separate matvecs far below the tier's ~1e-8
    accuracy contract, and each program must be deterministic."""
    from inference_tpu.ops.df64 import (
        split_f64,
        sqexp_matmat_df64,
        sqexp_matvec_df64,
    )

    rng = np.random.default_rng(0)
    n, d, q = 384, 2, 5
    x = rng.uniform(0, 8, size=(n, d))
    uh, ul = split_f64(x)
    V = rng.normal(size=(n, q))
    u64 = uh.astype(np.float64) + ul.astype(np.float64)
    d2 = ((u64[:, None, :] - u64[None, :, :]) ** 2).sum(-1)
    truth = np.exp(-0.5 * d2) @ V

    Y = np.asarray(sqexp_matmat_df64(uh, ul, V))
    assert np.abs(Y - truth).max() / np.abs(truth).max() < 1e-7
    scale = np.abs(truth).max()
    for k in range(q):
        yk = np.asarray(sqexp_matvec_df64(uh, ul, V[:, k]))
        assert np.abs(Y[:, k] - yk).max() / scale < 5e-8
    # per-program determinism: the same program is bit-reproducible
    assert np.array_equal(Y, np.asarray(sqexp_matmat_df64(uh, ul, V)))


def test_df64_multi_solver_matches_dense():
    """Df64MultiSolver solves a block of systems to df64 accuracy with
    per-column convergence, against a dense float64 solve."""
    from inference_tpu.ops.df64 import split_f64, sqexp_matmat_df64
    from inference_tpu.ops.solvers import Df64MultiSolver

    rng = np.random.default_rng(1)
    n, d, q = 256, 2, 4
    x = rng.uniform(0, 6, size=(n, d))
    uh, ul = split_f64(x)
    # kappa ~ n/sig2 ~ 2.5e4: converges unpreconditioned within the
    # budget (the small-noise preconditioned regime is exercised through
    # LargeScaleGP in tests/gp/test_LargeScaleGP.py)
    sig2 = 1e-2
    u64 = uh.astype(np.float64) + ul.astype(np.float64)
    d2 = ((u64[:, None, :] - u64[None, :, :]) ** 2).sum(-1)
    A = np.exp(-0.5 * d2) + sig2 * np.eye(n)
    B = rng.normal(size=(n, q))

    def matmat64(V32):
        EV = sqexp_matmat_df64(jnp.asarray(uh), jnp.asarray(ul), V32)
        return EV + sig2 * V32.astype(jnp.float64)

    solver = Df64MultiSolver(matmat64, restart_every=40)
    X, info = solver.solve(jnp.asarray(B), tol=1e-7, maxiter=2000)
    R = A @ np.asarray(X) - B
    rel = np.linalg.norm(R, axis=0) / np.linalg.norm(B, axis=0)
    # well below the f32 floor (~1e-3 here)
    assert rel.max() < 1e-6
    assert int(info) == 0


def test_sqexp_entries_df64_accuracy():
    """Stored pair entries match host float64 exp(-0.5 d^2) to the tier's
    ~1e-8 contract (relative, down to 1e-25-magnitude entries; below the
    low word's underflow scale only absolute accuracy is meaningful)."""
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("requires x64")
    from inference_tpu.ops.df64 import sqexp_entries_df64

    rng = np.random.default_rng(3)
    n, d = 256, 2
    x = rng.uniform(0, 10, size=(n, d)) / 0.7
    uh, ul = split_f64(x)
    u64 = _pair64(uh, ul)
    E64 = np.exp(-0.5 * ((u64[:, None, :] - u64[None, :, :]) ** 2).sum(-1))
    Eh, El = sqexp_entries_df64(uh, ul)
    E = _pair64(Eh, El)
    mask = E64 > 1e-25
    rel = np.abs(E - E64)[mask] / E64[mask]
    assert rel.max() < 5e-8
    assert np.abs(E - E64).max() < 1e-8


def test_sqexp_stored_matmat_matches_fused():
    """The stored-entries contraction reproduces the evaluate-per-matvec
    path and the float64 truth."""
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("requires x64")
    from inference_tpu.ops.df64 import (
        sqexp_entries_df64,
        sqexp_stored_matmat_df64,
        sqexp_stored_matvec_df64,
    )

    rng = np.random.default_rng(4)
    n, d = 256, 3
    x = rng.uniform(0, 6, size=(n, d))
    uh, ul = split_f64(x)
    u64 = _pair64(uh, ul)
    E64 = np.exp(-0.5 * ((u64[:, None, :] - u64[None, :, :]) ** 2).sum(-1))
    Eh, El = sqexp_entries_df64(uh, ul)

    V = rng.normal(size=(n, 4)).astype(np.float32)
    Y = np.asarray(sqexp_stored_matmat_df64(Eh, El, V))
    Y_true = E64 @ V.astype(np.float64)
    assert np.abs(Y - Y_true).max() / np.abs(Y_true).max() < 3e-8

    y = np.asarray(
        sqexp_stored_matvec_df64(Eh, El, V[:, 0])
    )
    y_fused = np.asarray(
        sqexp_matvec_df64(uh, ul, V[:, 0])
    )
    assert np.abs(y - y_fused).max() / np.abs(y_fused).max() < 1e-12


def test_rect_and_sharded_matmat_match_square():
    """The rectangular matmat reproduces the square one bitwise on the
    full row set and on row blocks, and the row-sharded mesh wrapper
    (the multi-device df64 matvec) reproduces it bitwise end to end."""
    import jax
    from jax.sharding import Mesh
    from inference_tpu.ops.df64 import (
        split_f64,
        sqexp_matmat_df64,
        sqexp_matmat_rect_df64,
        sqexp_matmat_df64_sharded,
    )

    rng = np.random.default_rng(2)
    n, q = 256, 2
    x = rng.uniform(0, 6, size=(n, 2))
    uh, ul = split_f64(x)
    V = rng.normal(size=(n, q))

    Y = np.asarray(sqexp_matmat_df64(uh, ul, V))
    Y_rect = np.asarray(sqexp_matmat_rect_df64(uh, ul, uh, ul, V))
    assert np.array_equal(Y, Y_rect)
    Y_rows = np.asarray(sqexp_matmat_rect_df64(uh[128:], ul[128:], uh, ul, V))
    assert np.array_equal(Y[128:], Y_rows)

    mesh = Mesh(np.array(jax.devices()[:2]), ("data",))
    Y_sh = np.asarray(
        sqexp_matmat_df64_sharded(
            jnp.asarray(uh), jnp.asarray(ul), jnp.asarray(V), mesh
        )
    )
    assert np.array_equal(Y, Y_sh)

    with pytest.raises(ValueError):  # rows must split into 128-multiples
        bad = Mesh(np.array(jax.devices()[:3]), ("data",))
        sqexp_matmat_df64_sharded(
            jnp.asarray(uh), jnp.asarray(ul), jnp.asarray(V), bad
        )


def test_sqexp_entries_f32_is_rounded_pair():
    """The f32 entry tier stores EXACTLY the rounded pair entries: each
    value is fl32 of the float64 kernel entry — crucially NOT the
    ~1.2e-5 float32-evaluated-entry noise."""
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("requires x64")
    from inference_tpu.ops.df64 import sqexp_entries_df64, sqexp_entries_f32

    rng = np.random.default_rng(5)
    n, d = 256, 2
    x = rng.uniform(0, 8, size=(n, d))
    uh, ul = split_f64(x)
    E = np.asarray(sqexp_entries_f32(uh, ul))
    Eh, El = sqexp_entries_df64(uh, ul)
    # identical evaluation pipeline: the stored f32 word IS the pair's
    # high word
    assert np.array_equal(E, np.asarray(Eh))
    u64 = _pair64(uh, ul)
    E64 = np.exp(-0.5 * ((u64[:, None, :] - u64[None, :, :]) ** 2).sum(-1))
    mask = E64 > 1e-20
    rel = np.abs(np.float64(E) - E64)[mask] / E64[mask]
    # rounding to one f32 word is at most 2^-24 ~ 6e-8 relative
    assert rel.max() < 1e-7


def test_sqexp_stored_f32_matmat_accuracy():
    """The stored-f32 contraction is exact to ~1e-15 with respect to the
    STORED matrix (a float64 contraction): the operator error is purely
    the entries' quantisation."""
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("requires x64")
    from inference_tpu.ops.df64 import sqexp_entries_f32, sqexp_stored_f32_matmat

    rng = np.random.default_rng(6)
    n, d, q = 256, 2, 3
    x = rng.uniform(0, 8, size=(n, d))
    uh, ul = split_f64(x)
    E = sqexp_entries_f32(uh, ul)
    V = rng.normal(size=(n, q)).astype(np.float32)
    Y = np.asarray(sqexp_stored_f32_matmat(E, jnp.asarray(V)))
    truth_stored = np.float64(np.asarray(E)) @ np.float64(V)
    rel = np.abs(Y - truth_stored).max() / np.abs(truth_stored).max()
    assert rel < 1e-13


def test_df64_solver_fast_iteration_matvec():
    """Df64Solver with a stored-f32 fast-iteration matvec converges to
    the same df64-level residual as the accurate-matvec solver: the
    fused refreshes anchor the truth, the cheap iterations do the work
    (mixed-precision iterative refinement)."""
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("requires x64")
    from inference_tpu.ops.df64 import (
        sqexp_entries_f32,
        sqexp_matvec_df64,
        sqexp_stored_f32_matmat,
    )
    from inference_tpu.ops.solvers import Df64Solver

    rng = np.random.default_rng(7)
    n, d = 256, 2
    x = rng.uniform(0, 6, size=(n, d))
    uh, ul = split_f64(x)
    sig2 = 1e-2
    u64 = _pair64(uh, ul)
    d2 = ((u64[:, None, :] - u64[None, :, :]) ** 2).sum(-1)
    A = np.exp(-0.5 * d2) + sig2 * np.eye(n)
    b = rng.normal(size=n)

    E = sqexp_entries_f32(uh, ul)
    uh_d, ul_d = jnp.asarray(uh), jnp.asarray(ul)

    def matvec64(v32):
        return sqexp_matvec_df64(uh_d, ul_d, v32) + sig2 * v32.astype(
            jnp.float64
        )

    def matvec_fast(v32, E):
        Ev = sqexp_stored_f32_matmat(E, v32.reshape(-1, 1))[:, 0]
        return Ev + sig2 * v32.astype(jnp.float64)

    solver = Df64Solver(
        matvec64,
        restart_every=40,
        matvec_fast=matvec_fast,
        matvec_fast_args=(E,),
    )
    xs, info = solver.solve(jnp.asarray(b), tol=1e-9, maxiter=2000)
    rel = np.linalg.norm(A @ np.asarray(xs) - b) / np.linalg.norm(b)
    assert rel < 1e-6
    assert int(info) == 0


def test_df64_solver_divergence_safeguard_returns_best_iterate():
    """The host loop must never return an iterate worse than the best
    one seen. Carrying the direction across true-residual refreshes can
    turn near-floor iteration into geometric divergence (measured at
    N=50,000, sigma=0.01: 3.9e-9 -> 1.4e+15 -> nan across three
    chunks with rz and pAp positive throughout); the safeguard restores
    a diverged column to its best state with a steepest-descent reset
    and freezes it on the second strike. Divergence is injected
    deterministically by corrupting the chunk output."""
    if not jax.config.read("jax_enable_x64"):
        pytest.skip("requires x64")
    from inference_tpu.ops.solvers import Df64Solver

    rng = np.random.default_rng(3)
    n = 200
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (Q * np.logspace(0, 4, n)) @ Q.T
    b = A @ rng.normal(size=n)
    A_dev = jnp.asarray(A)

    def matvec64(v32):
        return A_dev @ v32.astype(jnp.float64)

    solver = Df64Solver(matvec64, restart_every=20)
    real_chunk = solver._multi._chunk
    calls = {"n": 0}

    def corrupting_chunk(*args):
        X, R, Z, P, rz, ok, rr = real_chunk(*args)
        calls["n"] += 1
        if calls["n"] >= 4:
            # a diverged chunk: iterate and residual blown up, scalars
            # still positive (exactly the measured failure signature)
            X = X * 1e12
            R = R * 1e12
            rr = rr * 1e24
        return X, R, Z, P, rz, ok, rr

    solver._multi._chunk = corrupting_chunk
    # unreachable tol forces iteration into the corrupted chunks
    x, info = solver.solve(jnp.asarray(b), tol=1e-300, maxiter=400)
    # strike 1 restores the best state, strike 2 freezes: exactly 5 calls
    assert calls["n"] == 5
    assert int(info) != 0  # honest: tol was not reached
    # the returned iterate is the BEST one — bitwise the state after the
    # 3 clean chunks, exactly what an uncorrupted 60-iteration solve of
    # the same system produces — not the 1e12-corrupted one
    clean = Df64Solver(matvec64, restart_every=20)
    x_ref, _ = clean.solve(jnp.asarray(b), tol=1e-300, maxiter=60)
    np.testing.assert_array_equal(np.asarray(x), np.asarray(x_ref))


def test_stored_entries_tier_policy():
    """The single storage-policy function: 'auto' picks by size, True is
    a strict pair request (raises rather than silently downgrading the
    accuracy class or ignoring the request), 'f32' is an explicit
    opt-in at any size, False disables storage."""
    from inference_tpu.ops.df64 import stored_entries_tier

    assert stored_entries_tier(1024, "auto") == "pair"
    assert stored_entries_tier(20480, "auto") == "pair"
    assert stored_entries_tier(20608, "auto") == "f32"
    assert stored_entries_tier(53248, "auto") == "f32"
    assert stored_entries_tier(57344, "auto") is None

    assert stored_entries_tier(20480, True) == "pair"
    with pytest.raises(ValueError, match="store_entries='f32'"):
        stored_entries_tier(20608, True)
    with pytest.raises(ValueError, match="store_entries='f32'"):
        stored_entries_tier(57344, True)

    assert stored_entries_tier(20608, "f32") == "f32"
    assert stored_entries_tier(1024, "f32") == "f32"
    assert stored_entries_tier(1024, False) is None
    assert stored_entries_tier(57344, False) is None
