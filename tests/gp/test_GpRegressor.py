import numpy as np
import pytest

from inference_tpu.gp import (
    GpRegressor,
    SquaredExponential,
    RationalQuadratic,
    WhiteNoise,
    HeteroscedasticNoise,
    LinearMean,
    QuadraticMean,
)


def make_data(seed=0, n=25):
    rng = np.random.default_rng(seed)
    x = np.linspace(0, 10, n)
    y = np.sin(x) + 0.5 * x + rng.normal(0, 0.1, n)
    return x, y, np.full(n, 0.1)


def finite_difference_check(value_and_grad, value, theta, rtol=1e-5):
    _, grad = value_and_grad(theta)
    scale = max(np.abs(grad).max(), 1.0)
    for i in range(theta.size):
        eps = 1e-6
        tp, tm = theta.copy(), theta.copy()
        tp[i] += eps
        tm[i] -= eps
        fd = (value(tp) - value(tm)) / (2 * eps)
        # atol scaled to the gradient magnitude: central differences carry
        # absolute noise ~ |f| * 1e-10 / eps regardless of the component size
        assert np.isclose(grad[i], fd, rtol=rtol, atol=1e-6 * scale), (
            i,
            grad[i],
            fd,
        )


def test_gpr_prediction_accuracy():
    x, y, err = make_data()
    gp = GpRegressor(x, y, y_err=err)
    xq = np.linspace(0.5, 9.5, 40)
    mu, sig = gp(xq)
    truth = np.sin(xq) + 0.5 * xq
    assert np.sqrt(np.mean((mu - truth) ** 2)) < 0.15
    assert (sig > 0).all()


@pytest.mark.parametrize("cross_val", [False, True])
def test_gpr_likelihood_gradients_vs_finite_difference(cross_val):
    """Selector gradients match finite differences at random hyperparameter
    points (reference: tests/gp/test_GpRegressor.py:61-94). At the edges of
    the bounds K can be conditioned ~1e12, where central differences
    themselves carry ~1e-4 relative noise, so the FD tolerance is 1e-3; the
    tight 1e-8 contract is checked against the analytic trace-identity
    gradient in test_gpr_lml_gradient_vs_trace_identity."""
    x, y, err = make_data()
    gp = GpRegressor(x, y, y_err=err, cross_val=cross_val)
    rng = np.random.default_rng(7)
    lwr = np.array([b[0] for b in gp.hp_bounds])
    upr = np.array([b[1] for b in gp.hp_bounds])
    for _ in range(10):
        theta = lwr + (upr - lwr) * rng.random(lwr.size)
        finite_difference_check(
            gp.model_selector_gradient, gp.model_selector, theta, rtol=1e-3
        )


@pytest.mark.slow
def test_gpr_lml_gradient_vs_trace_identity():
    """The value_and_grad-through-Cholesky gradient matches the reference's
    analytic route (R&W eq. 5.9: dLML = 0.5 tr((alpha alpha^T - K^-1) dK),
    reference: regression.py:544-567) to high precision."""
    import jax.numpy as jnp
    from scipy.linalg import cholesky as sp_chol, solve_triangular as sp_solve

    x, y, err = make_data()
    gp = GpRegressor(x, y, y_err=err)
    rng = np.random.default_rng(11)
    lwr = np.array([b[0] for b in gp.hp_bounds])
    upr = np.array([b[1] for b in gp.hp_bounds])
    for _ in range(10):
        theta = lwr + 0.8 * (upr - lwr) * (0.1 + rng.random(lwr.size))
        _, grad_ad = gp.marginal_likelihood_gradient(theta)

        # independent analytic route in numpy float64
        K, dK_list = gp.cov.covariance_and_gradients(
            jnp.asarray(theta[gp.cov_slice])
        )
        K = np.asarray(K) + gp.sig
        mu, dmu_list = gp.mean.mean_and_gradients(jnp.asarray(theta[gp.mean_slice]))
        L = sp_chol(K, lower=True)
        iK = sp_solve(L, np.eye(K.shape[0]), lower=True)
        iK = iK.T @ iK
        alpha = iK @ (y - np.asarray(mu))
        Q = alpha[:, None] * alpha[None, :] - iK
        grad_ref = np.zeros(theta.size)
        grad_ref[gp.mean_slice] = [
            float((alpha * np.asarray(dmu)).sum()) for dmu in dmu_list
        ]
        grad_ref[gp.cov_slice] = [
            0.5 * float((Q * np.asarray(dK).T).sum()) for dK in dK_list
        ]
        assert np.allclose(grad_ad, grad_ref, rtol=1e-8, atol=1e-10)


def test_gpr_spatial_derivatives_vs_finite_difference():
    x, y, err = make_data()
    gp = GpRegressor(x, y, y_err=err)
    for q in [2.5, 5.0, 7.5]:
        dmu, dvar = gp.spatial_derivatives(np.array([[q]]))
        h = 1e-5
        m1, s1 = gp(np.array([[q - h]]))
        m2, s2 = gp(np.array([[q + h]]))
        assert np.isclose(float(dmu), (m2[0] - m1[0]) / (2 * h), rtol=1e-4)
        assert np.isclose(
            float(dvar), (s2[0] ** 2 - s1[0] ** 2) / (2 * h), rtol=1e-3, atol=1e-8
        )


def test_gpr_gradient_mean_vs_finite_difference():
    x, y, err = make_data()
    gp = GpRegressor(x, y, y_err=err)
    q = 5.0
    dmu, dcov = gp.gradient(np.array([[q]]))
    h = 1e-5
    m1, _ = gp(np.array([[q - h]]))
    m2, _ = gp(np.array([[q + h]]))
    assert np.isclose(float(dmu), (m2[0] - m1[0]) / (2 * h), rtol=1e-4)
    assert float(dcov) >= 0.0


def test_gpr_build_posterior():
    x, y, err = make_data()
    gp = GpRegressor(x, y, y_err=err)
    xq = np.linspace(1, 9, 10)
    mu, cov = gp.build_posterior(xq)
    assert mu.shape == (10,)
    assert cov.shape == (10, 10)
    # diagonal of the posterior covariance matches per-point variances
    _, sig = gp(xq)
    assert np.allclose(np.sqrt(np.abs(np.diag(cov))), sig, atol=1e-8)
    mu_only = gp.build_posterior(xq, mean_only=True)
    assert np.allclose(mu_only, mu)


def test_gpr_loo_predictions():
    x, y, err = make_data()
    gp = GpRegressor(x, y, y_err=err)
    mu, sig = gp.loo_predictions()
    assert mu.shape == (x.size,)
    assert (sig > 0).all()
    # LOO predictions should still be close to the data
    assert np.sqrt(np.mean((mu - y) ** 2)) < 0.5


def test_gpr_y_cov_input():
    x, y, err = make_data()
    y_cov = np.diag(err**2)
    gp1 = GpRegressor(x, y, y_cov=y_cov, hyperpars=np.array([2.0, 0.5, 0.5]))
    gp2 = GpRegressor(x, y, y_err=err, hyperpars=np.array([2.0, 0.5, 0.5]))
    mu1, _ = gp1(np.array([3.0]))
    mu2, _ = gp2(np.array([3.0]))
    assert np.isclose(mu1[0], mu2[0])


@pytest.mark.parametrize(
    "kernel",
    [
        RationalQuadratic,
        lambda: SquaredExponential() + WhiteNoise(),
        lambda: SquaredExponential() + HeteroscedasticNoise(),
    ],
)
def test_gpr_alternative_kernels(kernel):
    x, y, err = make_data(n=15)
    k = kernel()
    gp = GpRegressor(x, y, y_err=err, kernel=k)
    mu, sig = gp(np.array([5.0]))
    assert np.isfinite(mu).all() and np.isfinite(sig).all()
    # gradient of LML matches finite differences for each kernel, checked at
    # a deterministic mid-bounds point (fitted optima vary with the unseeded
    # multistart and can sit in ill-conditioned corners where central
    # differences themselves are inaccurate)
    lwr = np.array([b[0] for b in gp.hp_bounds])
    upr = np.array([b[1] for b in gp.hp_bounds])
    theta = 0.5 * (lwr + upr)
    finite_difference_check(
        gp.marginal_likelihood_gradient, gp.marginal_likelihood, theta, rtol=1e-4
    )


@pytest.mark.parametrize("mean", [LinearMean, QuadraticMean])
def test_gpr_alternative_means(mean):
    x, y, err = make_data(n=15)
    gp = GpRegressor(x, y, y_err=err, mean=mean)
    mu, sig = gp(np.array([5.0]))
    assert np.isfinite(mu).all()
    lwr = np.array([b[0] for b in gp.hp_bounds])
    upr = np.array([b[1] for b in gp.hp_bounds])
    theta = 0.5 * (lwr + upr)
    finite_difference_check(
        gp.marginal_likelihood_gradient, gp.marginal_likelihood, theta, rtol=1e-4
    )


def test_gpr_2d_regression():
    rng = np.random.default_rng(3)
    n = 40
    x = rng.uniform(0, 3, size=(n, 2))
    y = np.sin(x[:, 0]) * np.cos(x[:, 1]) + rng.normal(0, 0.05, n)
    gp = GpRegressor(x, y, y_err=np.full(n, 0.05))
    q = np.array([[1.5, 1.5]])
    mu, sig = gp(q)
    assert abs(mu[0] - np.sin(1.5) * np.cos(1.5)) < 0.2


def test_gpr_input_validation():
    x, y, err = make_data()
    with pytest.raises(ValueError):
        GpRegressor(x, np.stack([y, y], axis=1))  # 2D y
    with pytest.raises(ValueError):
        GpRegressor(x[:-1], y)  # size mismatch
    with pytest.raises(ValueError):
        GpRegressor(x, y, y_err=err[:-1])  # bad error size
    with pytest.raises(ValueError):
        gp = GpRegressor(x, y, y_err=err)
        gp.set_hyperparameters(np.ones(99))


def test_gpr_diffev_optimizer():
    x, y, err = make_data(n=12)
    gp = GpRegressor(x, y, y_err=err, optimizer="diffev")
    mu, sig = gp(np.array([5.0]))
    assert np.isfinite(mu).all()


@pytest.mark.slow
def test_gpr_device_optimizer():
    """The on-device vmapped multistart fit must find the same optimum as
    the host multistart L-BFGS-B."""
    x, y, err = make_data(n=30)
    gp_dev = GpRegressor(x, y, y_err=err, optimizer="device")
    gp_host = GpRegressor(x, y, y_err=err, optimizer="bfgs", n_starts=8)
    lml_dev = gp_dev.marginal_likelihood(gp_dev.hyperpars)
    lml_host = gp_host.marginal_likelihood(gp_host.hyperpars)
    assert lml_dev >= lml_host - 1e-4


@pytest.mark.slow
def test_gpr_fit_device_cross_val():
    x, y, err = make_data(n=20)
    gp = GpRegressor(x, y, y_err=err, cross_val=True, optimizer="device")
    assert np.isfinite(gp.loo_likelihood(gp.hyperpars))


@pytest.mark.slow
def test_gpr_padding_is_exact():
    """pad_to bucket padding produces numerically identical results to the
    unpadded computation (masked rows are identity rows of K)."""
    x, y, err = make_data(n=23)
    theta = np.array([1.0, 0.3, 0.7])
    plain = GpRegressor(x, y, y_err=err, hyperpars=theta)
    padded = GpRegressor(x, y, y_err=err, hyperpars=theta, pad_to=16)
    assert padded._n_padded == 32

    for t in [theta, theta + 0.2]:
        assert np.isclose(
            plain.marginal_likelihood(t), padded.marginal_likelihood(t), rtol=1e-12
        )
        assert np.isclose(
            plain.loo_likelihood(t), padded.loo_likelihood(t), rtol=1e-12
        )
        _, g1 = plain.marginal_likelihood_gradient(t)
        _, g2 = padded.marginal_likelihood_gradient(t)
        assert np.allclose(g1, g2, rtol=1e-10)

    xq = np.linspace(0.5, 9.5, 11)
    mu1, sig1 = plain(xq)
    mu2, sig2 = padded(xq)
    assert np.allclose(mu1, mu2, rtol=1e-10)
    assert np.allclose(sig1, sig2, rtol=1e-8)

    lm1, ls1 = plain.loo_predictions()
    lm2, ls2 = padded.loo_predictions()
    assert np.allclose(lm1, lm2, rtol=1e-8)
    assert np.allclose(ls1, ls2, rtol=1e-8)

    dm1, dv1 = plain.spatial_derivatives(np.array([[5.0]]))
    dm2, dv2 = padded.spatial_derivatives(np.array([[5.0]]))
    assert np.isclose(float(dm1), float(dm2), rtol=1e-8)
    assert np.isclose(float(dv1), float(dv2), rtol=1e-6, atol=1e-12)


@pytest.mark.slow
def test_gpr_update_data_matches_fresh_fit():
    """update_data + refit must give the same model as constructing a fresh
    GpRegressor on the combined data (compiled programs take the data as
    runtime arguments)."""
    x, y, err = make_data(n=24)
    gp = GpRegressor(x[:20], y[:20], y_err=err[:20], pad_to=16)
    gp.update_data(x, y, y_err=err)
    gp.set_hyperparameters(gp.fit(optimizer="bfgs", n_starts=4))

    fresh = GpRegressor(x, y, y_err=err, pad_to=16, n_starts=4)
    q = np.array([[2.5], [7.5]])
    mu_a, sig_a = gp(q)
    mu_b, sig_b = fresh(q)
    # both fits may land in the same basin from different starts; compare
    # the models at the same hyperparameters for an exact check
    gp.set_hyperparameters(fresh.hyperpars)
    mu_a, sig_a = gp(q)
    assert np.allclose(mu_a, mu_b, atol=1e-8)
    assert np.allclose(sig_a, sig_b, atol=1e-8)
    assert abs(gp.marginal_likelihood(fresh.hyperpars)
               - fresh.marginal_likelihood(fresh.hyperpars)) < 1e-8


def test_gpr_update_data_set_state_false_blocks_predictions():
    """update_data(set_state=False) leaves L/alpha computed from the OLD
    data (same padded shape, so nothing fails by shape) — predictions
    must raise until a refit settles the state, not silently mix new
    data with the old factorisation."""
    import pytest

    x, y, err = make_data(n=24)
    gp = GpRegressor(x[:20], y[:20], y_err=err[:20], pad_to=16)
    gp.update_data(x, y, y_err=err, set_state=False)
    q = np.array([[2.5], [7.5]])
    with pytest.raises(RuntimeError, match="stale"):
        gp(q)
    with pytest.raises(RuntimeError, match="stale"):
        gp.loo_predictions()
    # settling the state unblocks predictions
    gp.set_hyperparameters(gp.hyperpars)
    mu, sig = gp(q)
    assert np.isfinite(mu).all() and np.isfinite(sig).all()


def test_gpr_update_data_grows_bucket():
    x, y, err = make_data(n=40)
    gp = GpRegressor(x[:14], y[:14], y_err=err[:14], pad_to=16)
    assert gp._n_padded == 16
    gp.update_data(x, y, y_err=err)
    assert gp._n_padded == 48
    gp.set_hyperparameters(gp.fit())
    mu, sig = gp(np.array([[5.0]]))
    assert np.isfinite(mu).all() and np.isfinite(sig).all()


def test_pad_to_rejects_data_sized_kernels():
    """Shape padding cannot be combined with data-sized kernels (their
    hyperparameter count would track the padded shape)."""
    from inference_tpu.gp import SquaredExponential, HeteroscedasticNoise

    rng = np.random.default_rng(0)
    x = rng.uniform(0, 5, 50)
    y = np.sin(x) + rng.normal(0, 0.1, 50)
    with pytest.raises(ValueError):
        GpRegressor(
            x, y, kernel=SquaredExponential() + HeteroscedasticNoise(),
            pad_to=64,
        )


def test_gpr_explicit_dtype():
    """dtype='float32' pins the compiled programs to float32 even under an
    x64-enabled process (the x64 default would run the Cholesky in
    float64)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = np.linspace(0, 10, 40)
    y = np.sin(x) + rng.normal(0, 0.1, x.size)
    theta = np.array([0.0, 0.0, 0.3])
    gp32 = GpRegressor(x, y, y_err=np.full(x.size, 0.1), hyperpars=theta,
                       dtype="float32")
    assert gp32._x_dev.dtype == jnp.float32
    assert gp32.L.dtype == jnp.float32
    gp = GpRegressor(x, y, y_err=np.full(x.size, 0.1), hyperpars=theta)
    # float32 model agrees with the full-precision one to f32 accuracy
    q = np.linspace(1, 9, 7)
    mu32, sig32 = gp32(q)
    mu, sig = gp(q)
    assert np.allclose(mu32, mu, atol=1e-4)
    assert np.allclose(sig32, sig, atol=1e-4)
    lml32 = gp32.marginal_likelihood(theta)
    assert abs(lml32 - gp.marginal_likelihood(theta)) / abs(lml32) < 1e-5


@pytest.mark.slow
def test_blocked_cholesky_backend_matches_xla():
    """cholesky='blocked' (statically-unrolled matmul-panel factorisation)
    reproduces the default backend's LML, gradient, fit state and
    predictions; invalid options are rejected. Slow tier: the fast tier
    covers the blocked factorisation itself in tests/test_ops.py."""
    import jax.numpy as jnp
    from inference_tpu.gp import GpRegressor

    rng = np.random.default_rng(8)
    x = rng.uniform(0, 10, size=(300, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=300)
    err = np.full(300, 0.1)
    theta = None  # fit below

    base = GpRegressor(x, y, y_err=err)
    blocked = GpRegressor(x, y, y_err=err, cholesky=128)

    t = np.asarray(base.hyperpars)
    l0, g0 = base._lml_grad(jnp.asarray(t))
    l1, g1 = blocked._lml_grad(jnp.asarray(t))
    assert np.isclose(float(l0), float(l1), rtol=1e-8)
    assert np.allclose(np.asarray(g0), np.asarray(g1), rtol=1e-6, atol=1e-8)

    q = rng.uniform(0, 10, size=(40, 2))
    mu0, s0 = base(q)
    mu1, s1 = blocked(q)
    assert np.allclose(mu0, mu1, rtol=1e-6, atol=1e-8)
    assert np.allclose(s0, s1, rtol=1e-5, atol=1e-8)


def test_analytic_lml_gradient_matches_autodiff():
    """cholesky='analytic' (closed-form LML backward via the blocked
    triangular inverse, R&W eq. 5.9) reproduces the autodiff gradient to
    float64 roundoff — value, gradient, and through a composite kernel
    with a mean function. Run in x64 so agreement isolates correctness,
    not precision."""
    import jax.numpy as jnp
    from inference_tpu.gp import GpRegressor, WhiteNoise, LinearMean

    rng = np.random.default_rng(11)
    x = rng.uniform(0, 10, size=(150, 2))
    y = np.sin(x[:, 0]) + 0.2 * x[:, 1] + 0.1 * rng.normal(size=150)
    err = np.full(150, 0.1)

    for kwargs in (
        {},
        {"kernel": None, "mean": LinearMean},
    ):
        kw = {k: v for k, v in kwargs.items() if v is not None}
        base = GpRegressor(x, y, y_err=err, cholesky="xla", **kw)
        analytic = GpRegressor(x, y, y_err=err, cholesky="analytic", **kw)
        assert analytic._lml_raw is not base._lml_raw

        # compare away from the fitted optimum (where both gradients
        # are ~0 and relative comparison is meaningless)
        t = jnp.asarray(np.asarray(base.hyperpars) + 0.3)
        l0, g0 = base._lml_grad(t)
        l1, g1 = analytic._lml_grad(t)
        assert np.isclose(float(l0), float(l1), rtol=1e-10)
        assert np.allclose(
            np.asarray(g0), np.asarray(g1), rtol=1e-8, atol=1e-8
        )

    # the fit path (vmapped BFGS through the custom VJP) still works
    refit = GpRegressor(x, y, y_err=err, cholesky="analytic")
    assert np.isfinite(refit.marginal_likelihood(refit.hyperpars))

    # the LOO objective's tril-inverse K^-1 route (selected alongside
    # the analytic backward) matches the cho_solve route
    loo_a = GpRegressor(
        x, y, y_err=err, cholesky="analytic", cross_val=True
    )
    loo_x = GpRegressor(x, y, y_err=err, cholesky="xla", cross_val=True)
    t = jnp.asarray(np.asarray(loo_x.hyperpars) + 0.3)
    la, ga = loo_a._loo_grad(t)
    lx, gx = loo_x._loo_grad(t)
    assert np.isclose(float(la), float(lx), rtol=1e-10)
    assert np.allclose(np.asarray(ga), np.asarray(gx), rtol=1e-8, atol=1e-8)


@pytest.mark.parametrize(
    "n, dtype, expected",
    [
        (256, np.float64, "xla"),
        (2047, np.float64, "xla"),
        (2048, np.float64, "analytic"),
        (16384, np.float64, "analytic"),
        (2048, np.float32, "xla"),
        (16384, np.float32, "xla"),
    ],
)
def test_auto_gradient_path_policy(n, dtype, expected):
    """cholesky='auto' picks the gradient path from the padded size and
    the dtype (the analytic backward's float32 gradient is too coarse),
    never from the backend."""
    from inference_tpu.gp.regression import auto_gradient_path

    assert auto_gradient_path(n, np.dtype(dtype)) == expected


def test_auto_policy_selects_analytic_lml_at_crossover():
    """A float64 model at the crossover builds the closed-form backward for
    the LML gradient; a float32 one, or a smaller one, the autodiff
    objective."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 10, size=(40, 1))
    y = np.sin(x[:, 0])
    err = np.full(40, 0.1)
    theta = np.array([0.0, 0.0, 0.3])
    small = GpRegressor(x, y, y_err=err, hyperpars=theta)
    big = GpRegressor(x, y, y_err=err, hyperpars=theta, pad_to=2048)
    big32 = GpRegressor(x, y, y_err=err, hyperpars=theta, pad_to=2048,
                        dtype="float32")
    assert "make_lml_analytic" in big._lml_raw.__qualname__
    assert "make_lml_analytic" not in big32._lml_raw.__qualname__
    assert "make_lml_analytic" not in small._lml_raw.__qualname__
    v0, g0 = small.marginal_likelihood_gradient(theta)
    v1, g1 = big.marginal_likelihood_gradient(theta)
    assert np.isclose(v0, v1, rtol=1e-9)
    assert np.allclose(g0, g1, rtol=1e-7, atol=1e-9)


def test_analytic_lml_backward_differentiates_data_and_noise():
    """The closed-form backward gives the same cotangents as autodiff for
    every input — data, noise and jitter included — instead of zeros."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(12)
    x = rng.uniform(0, 10, size=(60, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=60)
    err = np.full(60, 0.1)
    theta = np.array([0.1, 0.2, 0.4, 0.3])
    base = GpRegressor(x, y, y_err=err, hyperpars=theta, cholesky="xla")
    analytic = GpRegressor(x, y, y_err=err, hyperpars=theta, cholesky="analytic")
    args = (jnp.asarray(theta), base._x_dev, base._y_dev, base._sig_dev,
            base._mask_dev, jnp.asarray(1e-6))
    grads = [
        jax.grad(lambda *a: gp._lml_raw(*a), argnums=(0, 1, 2, 3, 5))(*args)
        for gp in (base, analytic)
    ]
    for g_ref, g in zip(*grads):
        assert np.abs(np.asarray(g_ref)).max() > 0
        assert np.allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-7,
                           atol=1e-9)


def test_cholesky_option_validation():
    """Invalid cholesky= options are rejected at construction (fast tier:
    needs no fitting or factorisation)."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 10, size=(16, 1))
    y = np.sin(x[:, 0])
    err = np.full(16, 0.1)
    theta = np.zeros(3)
    with pytest.raises(ValueError):
        GpRegressor(x, y, y_err=err, hyperpars=theta, cholesky="bogus")
    with pytest.raises(ValueError):
        GpRegressor(x, y, y_err=err, hyperpars=theta, cholesky=True)
