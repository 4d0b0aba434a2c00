import numpy as np
import pytest

from inference_tpu.mcmc import GibbsChain
from mcmc_utils import rosenbrock, sliced_length


def make_chain(n=500, seed=7):
    chain = GibbsChain(
        posterior=rosenbrock,
        start=np.array([2.0, -4.0]),
        widths=np.array([0.2, 0.4]),
        display_progress=False,
        seed=seed,
    )
    chain.advance(n)
    return chain


def test_gibbs_chain_advance():
    chain = make_chain(n=200)
    assert chain.chain_length == 201
    assert chain.get_sample().shape == (200, 2)
    assert chain.get_probabilities().size == 200
    # all recorded probabilities are finite
    assert np.isfinite(chain.get_probabilities()).all()


@pytest.mark.parametrize(
    "burn",
    [0, pytest.param(1, marks=pytest.mark.slow),
     pytest.param(5, marks=pytest.mark.slow), 100],
)
@pytest.mark.parametrize(
    "thin",
    [1, pytest.param(3, marks=pytest.mark.slow),
     pytest.param(7, marks=pytest.mark.slow)],
)
def test_gibbs_chain_burn_thin_slicing(burn, thin):
    chain = make_chain(n=300)
    expected = sliced_length(chain.chain_length, burn, thin)
    assert chain.get_sample(burn=burn, thin=thin).shape == (expected, 2)
    assert chain.get_parameter(0, burn=burn, thin=thin).size == expected
    assert chain.get_probabilities(burn=burn, thin=thin).size == expected


@pytest.mark.slow
def test_gibbs_chain_statistics():
    chain = make_chain(n=20000, seed=11)
    s = chain.get_sample(burn=5000)
    # the rosenbrock posterior is symmetric in x
    assert abs(s[:, 0].mean()) < 0.15
    # y concentrates on the parabola y = x^2 > 0
    assert 0.1 < s[:, 1].mean() < 0.8


@pytest.mark.slow
def test_gibbs_chain_non_negative():
    chain = GibbsChain(
        posterior=rosenbrock,
        start=np.array([2.0, 4.0]),
        widths=np.array([0.2, 0.4]),
        display_progress=False,
        seed=2,
    )
    chain.set_non_negative(1)
    chain.advance(500)
    assert (chain.get_parameter(1) >= 0).all()


@pytest.mark.slow
def test_gibbs_chain_boundaries():
    chain = GibbsChain(
        posterior=rosenbrock,
        start=np.array([0.5, 0.5]),
        widths=np.array([0.2, 0.4]),
        display_progress=False,
        seed=2,
    )
    left, right = (0.45, 0.55)
    chain.set_boundaries(0, (left, right))
    chain.advance(500)
    p = chain.get_parameter(0)
    assert (p >= left).all() and (p <= right).all()


@pytest.mark.slow
def test_gibbs_chain_save_load(tmp_path):
    chain = make_chain(n=300)
    f = tmp_path / "gibbs.npz"
    chain.save(str(f))
    loaded = GibbsChain.load(str(f), posterior=rosenbrock)

    assert loaded.chain_length == chain.chain_length
    assert np.array_equal(loaded.get_sample(), chain.get_sample())
    assert np.array_equal(loaded.get_probabilities(), chain.get_probabilities())
    # the loaded chain can continue sampling
    loaded.advance(50)
    assert loaded.chain_length == chain.chain_length + 50


@pytest.mark.slow
def test_gibbs_chain_mode():
    chain = make_chain(n=1000)
    mode = chain.mode()
    probs = chain.get_probabilities(burn=0)
    # mode must correspond to the max recorded probability
    assert np.isclose(float(rosenbrock(mode)), probs.max())


@pytest.mark.slow
def test_gibbs_chain_get_interval():
    chain = make_chain(n=1000)
    sample, probs = chain.get_interval(interval=0.5)
    assert sample.shape[0] == probs.size
    assert probs.min() >= np.percentile(chain.get_probabilities(), 49)


def test_gibbs_chain_burn_thin_attribute_errors():
    chain = make_chain(n=10)
    with pytest.raises(AttributeError):
        chain.burn
    with pytest.raises(AttributeError):
        chain.burn = 5
    with pytest.raises(AttributeError):
        chain.thin
    with pytest.raises(AttributeError):
        chain.thin = 5


def test_gibbs_chain_invalid_posterior():
    with pytest.raises(ValueError):
        GibbsChain(posterior=42, start=np.array([1.0, 1.0]))

    def bad_posterior(t):
        return np.array([1.0, 2.0])

    with pytest.raises(ValueError):
        GibbsChain(posterior=bad_posterior, start=np.array([1.0, 1.0]))

    def nan_posterior(t):
        return float("nan")

    with pytest.raises(ValueError):
        GibbsChain(posterior=nan_posterior, start=np.array([1.0, 1.0]))


def test_gibbs_numpy_posterior_callback():
    """Non-traceable numpy posteriors run through the host-callback path."""

    def np_posterior(t):
        t = np.asarray(t)
        return float(-0.5 * np.sum((t - 1.0) ** 2))

    chain = GibbsChain(
        posterior=np_posterior,
        start=np.array([0.5, 0.5]),
        widths=np.array([0.3, 0.3]),
        display_progress=False,
        seed=1,
    )
    chain.advance(400)
    s = chain.get_sample(burn=100)
    assert abs(s.mean() - 1.0) < 0.3


def test_numpy_posterior_runs_in_chain_array():
    """A numpy-only (non-traceable) posterior is evaluated through a host
    callback inside the compiled ChainArray loop and samples correctly."""
    from inference_tpu.parallel import ChainArray

    def np_posterior(t):
        return float(-0.5 * np.sum((np.asarray(t) - 1.0) ** 2))

    ca = ChainArray(
        "metropolis", np_posterior, np.zeros((4, 2)), widths=1.0, seed=2
    )
    ca.advance(300)
    s = ca.get_sample(burn=100)
    assert np.isfinite(s).all()
    assert np.all(np.abs(s.mean(axis=0) - 1.0) < 0.3)


@pytest.mark.slow
def test_gibbs_run_for_wall_clock():
    """run_for advances the chain for (at least) the requested duration."""
    from time import time

    chain = GibbsChain(
        posterior=rosenbrock,
        start=np.array([2.0, -4.0]),
        widths=np.array([0.2, 0.4]),
        display_progress=False,
        seed=1,
    )
    chain.advance(10)  # compile outside the timed window
    start_len = chain.chain_length
    t0 = time()
    chain.run_for(minutes=0.03)
    elapsed = time() - t0
    assert chain.chain_length > start_len
    assert elapsed >= 0.03 * 60 * 0.9


def test_gibbs_run_for_interval_adaptation(monkeypatch):
    """run_for's update-interval scheduling, pinned deterministically.

    The reference pins run_for's scheduling with freezegun
    (reference: tests/mcmc/test_gibbs.py:161-235); here the module's
    ``time`` is replaced by a fake clock that advances a fixed cost per
    chain step, making the adaptation loop in ``mcmc/base.py::run_for``
    exactly reproducible: intervals must be powers of two (bounding the
    set of compiled chunk shapes), converge to one batch per fake
    second, and the loop must stop at the first poll past the deadline.
    """
    import inference_tpu.mcmc.base as base_mod

    chain = GibbsChain(
        posterior=rosenbrock,
        start=np.array([2.0, -4.0]),
        widths=np.array([0.2, 0.4]),
        display_progress=False,
        seed=3,
    )
    chain.advance(4)  # compile outside the fake-clock window
    start_len = chain.chain_length

    step_cost = 1.0 / 300.0  # fake seconds per chain step
    clock = {"t": 1000.0}
    intervals = []
    real_advance_n = chain._advance_n

    def fake_time():
        return clock["t"]

    def instrumented_advance_n(n):
        intervals.append(n)
        clock["t"] += n * step_cost
        real_advance_n(n)

    monkeypatch.setattr(base_mod, "time", fake_time)
    monkeypatch.setattr(chain, "_advance_n", instrumented_advance_n)
    run_seconds = 10.0
    chain.run_for(minutes=run_seconds / 60.0)

    steps = chain.chain_length - start_len
    assert steps == sum(intervals)
    # the first batch is the fixed initial guess; every adapted batch
    # size after it is a power of two (run_for rounds the adapted rate
    # down so the compiled chunk-shape set stays bounded)
    assert intervals[0] == 20
    assert all(n & (n - 1) == 0 for n in intervals[1:])
    # the adapted interval converges to ~one batch/second: the largest
    # power of two <= 300 steps/s is 256
    assert intervals[-1] == 256
    assert intervals.count(256) >= 2
    # stops at the first poll past the deadline: total fake time covers
    # run_seconds but overshoots by less than one final batch
    fake_elapsed = steps * step_cost
    assert fake_elapsed >= run_seconds
    assert fake_elapsed < run_seconds + 256 * step_cost + 1e-9
