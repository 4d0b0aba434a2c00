import numpy as np
import pytest
import jax
import jax.numpy as jnp

from inference_tpu.ops.pairwise import (
    scaled_sq_distances,
    scaled_sq_differences,
    sqexp_covariance,
)
from inference_tpu.utils.ess import (
    effective_sample_size,
    effective_sample_size_batched,
)


def test_scaled_sq_distances_matches_direct():
    rng = np.random.default_rng(0)
    u = rng.normal(size=(33, 4))
    v = rng.normal(size=(17, 4))
    ls = np.array([0.5, 1.0, 2.0, 0.7])
    D = np.asarray(scaled_sq_distances(u, v, ls))
    direct = (((u[:, None, :] - v[None, :, :]) / ls) ** 2).sum(-1)
    assert np.allclose(D, direct, atol=1e-9)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_sqexp_covariance_values(dtype):
    """Both dtype paths match the host float64 direct evaluation, with an
    exact diagonal."""
    rng = np.random.default_rng(1)
    u = rng.normal(size=(10, 2))
    ls = np.array([0.8, 1.3])
    K = np.asarray(
        sqexp_covariance(jnp.asarray(u, dtype), jnp.asarray(u, dtype), 1.5,
                         jnp.asarray(ls, dtype))
    )
    direct = 1.5**2 * np.exp(
        -0.5 * (((u[:, None, :] - u[None, :, :]) / ls) ** 2).sum(-1)
    )
    tol = 1e-10 if dtype == jnp.float64 else 1e-5
    assert K.dtype == dtype
    assert np.allclose(K, direct, atol=tol)
    assert np.allclose(np.diag(K), 1.5**2, atol=tol)


def test_sqexp_difference_form_beats_matmul_form_in_float32():
    """The float32 difference form matches the float64 distances to a few
    ulps, and is exact on the diagonal where the matmul form cancels."""
    rng = np.random.default_rng(2)
    u = rng.uniform(0, 10, size=(300, 3))
    v = rng.uniform(0, 10, size=(260, 3))
    ls = np.array([0.7, 1.1, 0.9])
    truth = (((u[:, None, :] - v[None, :, :]) / ls) ** 2).sum(-1)
    u32, v32, l32 = (jnp.asarray(a, jnp.float32) for a in (u, v, ls))
    diff = np.asarray(scaled_sq_differences(u32, v32, l32), np.float64)
    matmul = np.asarray(scaled_sq_distances(u32, v32, l32), np.float64)
    err_diff = np.abs(diff - truth).max()
    err_matmul = np.abs(matmul - truth).max()
    assert err_diff < 1e-5 * truth.max()
    assert err_diff < err_matmul
    self_d = np.asarray(scaled_sq_differences(u32, u32, l32))
    assert np.all(np.diag(self_d) == 0.0)


def test_ess_known_autocorrelation():
    """An AR(1) series with coefficient rho has ESS ~ N (1-rho)/(1+rho)."""
    rng = np.random.default_rng(3)
    n, rho = 40000, 0.7
    x = np.empty(n)
    x[0] = rng.normal()
    for i in range(1, n):
        x[i] = rho * x[i - 1] + rng.normal() * np.sqrt(1 - rho**2)
    ess = effective_sample_size(x)
    expected = n * (1 - rho) / (1 + rho)
    # the truncate-at-first-negative estimator (reference semantics) cuts
    # the autocorrelation sum early, biasing the ESS upward somewhat
    assert 0.5 * expected < ess < 2.0 * expected


def test_ess_batched_matches_host():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5000)).cumsum(axis=1) * 0.01 + rng.normal(
        size=(3, 5000)
    )
    batched = np.asarray(effective_sample_size_batched(jnp.asarray(x)))
    host = np.array([effective_sample_size(row) for row in x])
    # truncation points can differ by one lag; allow small deviation
    assert np.allclose(batched, host, rtol=0.1)


def _sqexp_direct(u, v, amp, ls):
    d = (((u[:, None, :] - v[None, :, :]) / ls) ** 2).sum(-1)
    return amp**2 * jnp.exp(-0.5 * d)


def test_sqexp_covariance_hyperparameter_grad_matches_direct():
    """Reverse-mode hyperparameter gradients of the float32 (difference
    form) path match autodiff of a direct float64 evaluation."""
    rng = np.random.default_rng(7)
    u = rng.normal(size=(40, 2))
    kbar = rng.normal(size=(40, 40))

    def loss(fn, dtype):
        u_ = jnp.asarray(u, dtype)
        kb = jnp.asarray(kbar, dtype)
        return lambda amp, ls: jnp.sum(fn(u_, u_, amp, ls) * kb)

    g_ref = jax.grad(loss(_sqexp_direct, jnp.float64), argnums=(0, 1))(
        jnp.asarray(1.3), jnp.asarray([0.8, 1.2])
    )
    g32 = jax.grad(loss(sqexp_covariance, jnp.float32), argnums=(0, 1))(
        jnp.asarray(1.3, jnp.float32), jnp.asarray([0.8, 1.2], jnp.float32)
    )
    assert np.isclose(float(g32[0]), float(g_ref[0]), rtol=1e-4)
    assert np.allclose(np.asarray(g32[1]), np.asarray(g_ref[1]), rtol=1e-4)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_sqexp_covariance_position_grad_matches_direct(dtype):
    """Position cotangents match autodiff of the direct evaluation."""
    rng = np.random.default_rng(11)
    u = jnp.asarray(rng.normal(size=(40, 3)), dtype)
    v = jnp.asarray(rng.normal(size=(48, 3)), dtype)
    kbar = jnp.asarray(rng.normal(size=(40, 48)), dtype)
    amp = jnp.asarray(0.9, dtype)
    ls = jnp.asarray([0.8, 1.2, 1.5], dtype)

    def grads(fn):
        return jax.grad(
            lambda u, v: jnp.sum(fn(u, v, amp, ls) * kbar), argnums=(0, 1)
        )(u, v)

    g_ref = grads(_sqexp_direct)
    g = grads(sqexp_covariance)
    rtol = 1e-8 if dtype == jnp.float64 else 1e-4
    for a, b in zip(g, g_ref):
        assert np.allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=rtol)


def test_ess_batched_constant_chain_sentinel():
    """A constant (stuck) chain lane returns the sentinel 0 instead of
    NaN-cast-to-int garbage; healthy lanes are unaffected."""
    from inference_tpu.utils.ess import (
        effective_sample_size,
        effective_sample_size_batched,
    )

    rng = np.random.default_rng(3)
    healthy = rng.normal(size=512)
    # exactly-representable constant -> centred series is exactly zero
    stuck = np.full(512, 2.0)
    batched = np.asarray(
        effective_sample_size_batched(jnp.asarray(np.stack([healthy, stuck])))
    )
    assert batched[1] == 0
    assert np.isclose(batched[0], effective_sample_size(healthy), rtol=0.1)


def test_hmc_step_default_momentum():
    """make_hmc_step without a mass_sample uses a unit-normal momentum
    (identity-mass default, matching the mass_velocity fallback)."""
    from inference_tpu.mcmc._kernels.hmc import (
        make_hmc_step,
        init_hmc_state,
        run_steps,
    )

    logp = lambda t: -0.5 * (t * t).sum()
    step = make_hmc_step(logp, jax.grad(logp), retry=False)
    state = init_hmc_state(
        jnp.ones(3), logp(jnp.ones(3)), 0.2, jax.random.PRNGKey(0), steps=5
    )
    state, outs = run_steps(step, state, 50)
    assert bool(jnp.isfinite(state.theta).all())
    assert not bool(jnp.allclose(state.theta, 1.0))  # it moved


def test_sample_hdi_device_single_column():
    """A (m, 1) input keeps its column axis — shape (2, 1), matching the
    host sample_hdi."""
    from inference_tpu.pdf.hdi import sample_hdi_device
    from inference_tpu.pdf import sample_hdi

    x = np.random.default_rng(0).normal(size=400)
    dev = np.asarray(sample_hdi_device(jnp.asarray(x.reshape(-1, 1)), 0.68))
    host = sample_hdi(x.reshape(-1, 1), 0.68)
    assert dev.shape == host.shape == (2, 1)
    assert np.allclose(dev, host)
    flat = np.asarray(sample_hdi_device(jnp.asarray(x), 0.68))
    assert flat.shape == (2,)


def test_make_key_wide_seeds():
    """64-bit and negative seeds fold into 32 bits instead of raising
    (numpy >= 2 errors on out-of-range uint32 casts)."""
    from inference_tpu.utils import make_key

    assert make_key(2**33) is not None
    assert make_key(-1) is not None
    # folding is deterministic
    a = np.asarray(jax.random.normal(make_key(2**33), (3,)))
    b = np.asarray(jax.random.normal(make_key(2**33), (3,)))
    assert np.array_equal(a, b)


def test_ess_constant_series_message():
    with np.errstate(invalid="ignore"):
        try:
            effective_sample_size(np.ones(64))
            raised = False
        except ValueError as e:
            raised = "positive" in str(e) and "variance" in str(e)
    assert raised


def test_covariance_and_gradients_forward_mode():
    """The generic jacfwd gradient path runs through sqexp_covariance and
    matches finite differences of the covariance."""
    from inference_tpu.gp import SquaredExponential

    k = SquaredExponential()
    x = np.random.default_rng(0).normal(size=(64, 2))
    k.pass_spatial_data(jnp.asarray(x))
    theta = np.array([0.1, 0.0, 0.2])
    K2, grads = k.covariance_and_gradients(jnp.asarray(theta))
    assert len(grads) == 3 and K2.shape == (64, 64)
    h = 1e-6
    for i in range(3):
        tp, tm = theta.copy(), theta.copy()
        tp[i] += h
        tm[i] -= h
        fd = (np.asarray(k.build_covariance(jnp.asarray(tp)))
              - np.asarray(k.build_covariance(jnp.asarray(tm)))) / (2 * h)
        assert np.allclose(np.asarray(grads[i]), fd, atol=1e-6)


def test_blocked_cholesky_matches_xla():
    """Statically-unrolled blocked Cholesky (ops/linalg.py) reproduces the
    XLA factor on a padded size, and its symmetrised logdet gradient is
    the analytic K^-1 (the exhaustive size x method sweep is slow-tier)."""
    from inference_tpu.ops.linalg import blocked_cholesky

    rng = np.random.default_rng(3)
    n, block = 300, 128
    A = rng.normal(size=(n, n))
    K = jnp.asarray(A @ A.T + n * np.eye(n))
    L_ref = np.linalg.cholesky(np.asarray(K))
    L = np.asarray(blocked_cholesky(K, block=block, method="trsm"))
    assert np.allclose(np.tril(L), L)
    assert np.allclose(L, L_ref, rtol=1e-9, atol=1e-9)

    g = jax.grad(
        lambda K: jnp.sum(jnp.log(jnp.diag(blocked_cholesky(K, block=128))))
    )(K)
    sym = g + g.T  # logdet gradient: sym(g) == K^-1 for symmetric K
    assert np.allclose(np.asarray(sym), np.linalg.inv(np.asarray(K)), atol=1e-8)


def test_blocked_tril_inverse_and_gram():
    """blocked_tril_inverse gives L^-1 and tril_gram(L^-1) gives K^-1
    (the analytic-LML-backward building blocks), across padded and
    exact-multiple sizes, including the single-block fast path."""
    from inference_tpu.ops.linalg import blocked_tril_inverse, tril_gram

    rng = np.random.default_rng(5)
    for n, block in [(300, 128), (256, 128), (100, 128)]:
        A = rng.normal(size=(n, n))
        K = np.asarray(A @ A.T + n * np.eye(n))
        L = np.linalg.cholesky(K)
        X = np.asarray(blocked_tril_inverse(jnp.asarray(L), block=block))
        assert np.allclose(X, np.linalg.inv(L), rtol=1e-9, atol=1e-10)
        assert np.allclose(np.triu(X, 1), 0.0)
        G = np.asarray(tril_gram(jnp.asarray(X), block=block))
        assert np.allclose(G, np.linalg.inv(K), rtol=1e-8, atol=1e-10)
        assert np.allclose(G, G.T)


@pytest.mark.slow
def test_blocked_cholesky_sweep_matches_xla():
    """Both solve methods across padded and exact-multiple sizes."""
    from inference_tpu.ops.linalg import blocked_cholesky

    rng = np.random.default_rng(3)
    for n, block in [(384, 128), (300, 128), (120, 256)]:
        A = rng.normal(size=(n, n))
        K = jnp.asarray(A @ A.T + n * np.eye(n))
        L_ref = np.linalg.cholesky(np.asarray(K))
        for method in ("inv", "trsm"):
            L = np.asarray(blocked_cholesky(K, block=block, method=method))
            assert np.allclose(np.tril(L), L)
            assert np.allclose(L, L_ref, rtol=1e-9, atol=1e-9)
