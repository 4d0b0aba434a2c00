"""Gaussian kernel-density estimation.

JAX rebuild of the reference ``GaussianKDE`` / ``KDE2D``
(reference: inference/pdf/kde.py:13-325). The reference prunes kernel sums
spatially with a ``BinaryTree`` of axis regions (reference: kde.py:76-113);
here evaluation is a **dense vectorised kernel sum** on device — an (M, N)
elementwise block that XLA fuses, chunked over query points to bound memory.
On accelerators this is faster than the host-side pruned loop for any
realistic sample size, and it is exact rather than cutoff-truncated.

Bandwidth selection: Silverman's rule by default, or leave-one-out
cross-validation maximised over a self-extending, recursively-refined grid
in log-bandwidth (reference: kde.py:139-208; the grid logic here works in
``log(h)`` where the reference mixes bandwidth and log-bandwidth units).
"""

import numpy as np
import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp, erf
from scipy.integrate import simpson
from scipy.optimize import minimize_scalar

from .hdi import sample_hdi
from .base import DensityEstimator

_CHUNK = 4096  # query-point chunk size for the dense kernel sum


@jax.jit
def _kde_pdf(x, sample, q, norm):
    dx = x[:, None] - sample[None, :]
    return jnp.exp(-((dx * q) ** 2)).sum(axis=1) * norm


@jax.jit
def _kde_cdf(x, sample, q):
    dx = x[:, None] - sample[None, :]
    return 0.5 * (1.0 + erf(dx * q)).mean(axis=1)


@jax.jit
def _loo_cv_logprob(sample, h, c=0.99):
    """Leave-one-out cross-validation log-probability for bandwidth ``h``
    (reference: kde.py:195-208)."""
    n = sample.shape[0]
    z = (sample[:, None] - sample[None, :]) / h
    log_norm = jnp.log(n * h * jnp.sqrt(2 * jnp.pi))
    log_pdf = logsumexp(-0.5 * z**2, axis=1) - log_norm
    d = jnp.log(c) - log_norm - log_pdf
    log_probs = log_pdf + jnp.log(1 - jnp.exp(d))
    return log_probs.sum()


class GaussianKDE(DensityEstimator):
    """
    Gaussian kernel-density estimate of a 1D sample's PDF.

    :param sample: 1D array of samples.
    :param bandwidth: optional fixed kernel bandwidth; estimated from the
        data when omitted.
    :param cross_validation: select the bandwidth by leave-one-out
        cross-validation instead of Silverman's rule.
    :param max_cv_samples: cap on the number of samples used in the
        cross-validation (cost is quadratic in the sample count).
    """

    def __init__(
        self,
        sample,
        bandwidth: float = None,
        cross_validation: bool = False,
        max_cv_samples: int = 5000,
    ):
        self.sample = np.sort(np.asarray(sample, dtype=float).flatten())
        self.max_cvs = max_cv_samples

        if self.sample.size < 3:
            raise ValueError(
                "[ GaussianKDE error ] Not enough samples were given to "
                "estimate the PDF. At least 3 samples are required."
            )

        if bandwidth is None:
            self.h = self.simple_bandwidth_estimator()
            if cross_validation:
                self.h = self.cross_validation_bandwidth_estimator(self.h)
        else:
            self.h = float(bandwidth)

        self.norm = 1.0 / (len(self.sample) * np.sqrt(2 * np.pi) * self.h)
        self.cutoff = self.h * 4
        self.q = 1.0 / (np.sqrt(2) * self.h)
        self.lwr_limit = self.sample[0] - self.cutoff * 0.5
        self.upr_limit = self.sample[-1] + self.cutoff * 0.5

        self._sample_dev = jnp.asarray(self.sample)
        self.mode = self.locate_mode()

    def __call__(self, x):
        """Evaluate the PDF estimate at the given locations."""
        x = np.atleast_1d(np.asarray(x, dtype=float))
        out = np.empty(x.size)
        for i in range(0, x.size, _CHUNK):
            chunk = jnp.asarray(x[i : i + _CHUNK])
            out[i : i + _CHUNK] = np.asarray(
                _kde_pdf(chunk, self._sample_dev, self.q, self.norm)
            )
        return out if out.size > 1 else out[0]

    def cdf(self, x):
        """Evaluate the CDF estimate at the given locations."""
        x = np.atleast_1d(np.asarray(x, dtype=float))
        out = np.empty(x.size)
        for i in range(0, x.size, _CHUNK):
            chunk = jnp.asarray(x[i : i + _CHUNK])
            out[i : i + _CHUNK] = np.asarray(
                _kde_cdf(chunk, self._sample_dev, self.q)
            )
        return out if out.size > 1 else out[0]

    def simple_bandwidth_estimator(self) -> float:
        """Silverman's rule-of-thumb bandwidth (reference: kde.py:135-137)."""
        return 1.06 * float(self.sample.std()) / (self.sample.size**0.2)

    def cross_validation_bandwidth_estimator(self, initial_h: float) -> float:
        """
        Maximise the LOO-CV log-probability over a self-extending grid in
        log-bandwidth, followed by recursive refinement around the maximum.
        """
        if len(self.sample) > self.max_cvs:
            rng = np.random.default_rng()
            idx = rng.choice(self.sample.size, self.max_cvs, replace=False)
            samples = jnp.asarray(self.sample[idx])
        else:
            samples = jnp.asarray(self.sample)

        def cv(log_h):
            return float(_loo_cv_logprob(samples, jnp.exp(log_h)))

        dh = 0.5
        log_h = [np.log(initial_h) + m * dh for m in (-2, -1, 0, 1, 2)]
        log_p = [cv(h) for h in log_h]

        # extend the grid if the maximum is at an edge
        for _ in range(5):
            max_ind = int(np.argmax(log_p))
            if 0 < max_ind < len(log_h) - 1:
                break
            if max_ind == 0:
                new_h = log_h[0] - dh
                log_h.insert(0, new_h)
                log_p.insert(0, cv(new_h))
            else:
                new_h = log_h[-1] + dh
                log_h.append(new_h)
                log_p.append(cv(new_h))

        # recursive refinement around the maximum
        for _ in range(6):
            max_ind = int(np.argmax(log_p))
            max_ind = min(max(max_ind, 1), len(log_h) - 2)
            lwr_h = 0.5 * (log_h[max_ind - 1] + log_h[max_ind])
            upr_h = 0.5 * (log_h[max_ind] + log_h[max_ind + 1])
            log_h.insert(max_ind, lwr_h)
            log_p.insert(max_ind, cv(lwr_h))
            log_h.insert(max_ind + 2, upr_h)
            log_p.insert(max_ind + 2, cv(upr_h))

        return float(np.exp(log_h[int(np.argmax(log_p))]))

    def locate_mode(self) -> float:
        """Find the PDF mode by bounded scalar minimisation over the 20% HDI
        (reference: kde.py:220-230)."""
        if self.sample.size > 50:
            lwr, upr = sample_hdi(self.sample, 0.2)
        else:
            lwr, upr = self.sample[0], self.sample[-1]
        if lwr == upr:
            return float(lwr)
        result = minimize_scalar(
            lambda x: -float(self(x)), bounds=[lwr, upr], method="bounded"
        )
        return float(result.x)

    def moments(self):
        """
        Mean, variance, skewness and excess kurtosis of the estimated PDF,
        by Simpson integration of the estimate itself.
        """
        N = int(5 * (self.upr_limit - self.lwr_limit) / self.h)
        x = np.linspace(self.lwr_limit, self.upr_limit, N)
        p = np.asarray(self(x))

        mu = simpson(p * x, x=x)
        dx = x - mu
        I = p * dx**2
        var = simpson(I, x=x)
        I *= dx
        skw = simpson(I, x=x) / var**1.5
        I *= dx
        kur = (simpson(I, x=x) / var**2) - 3.0
        return mu, var, skw, kur

    def interval(self, fraction: float = 0.95):
        return super().interval(fraction)


class KDE2D:
    """
    Simple 2D product-kernel KDE with correlation-corrected bandwidths,
    used by the matrix-plot contouring (reference: kde.py:256-280). The
    evaluation is a vectorised device kernel sum over all query points.
    """

    def __init__(self, x, y):
        self.x = np.asarray(x, dtype=float)
        self.y = np.asarray(y, dtype=float)
        s_x, s_y = self.estimate_bandwidth(self.x, self.y)
        self.q_x = 1.0 / (np.sqrt(2) * s_x)
        self.q_y = 1.0 / (np.sqrt(2) * s_y)
        self.norm = 1.0 / (len(self.x) * np.sqrt(2 * np.pi) * s_x * s_y)
        self._x_dev = jnp.asarray(self.x)
        self._y_dev = jnp.asarray(self.y)

    def __call__(self, x_vals, y_vals):
        xq = np.atleast_1d(np.asarray(x_vals, dtype=float))
        yq = np.atleast_1d(np.asarray(y_vals, dtype=float))
        out = np.empty(xq.size)
        for i in range(0, xq.size, _CHUNK):
            out[i : i + _CHUNK] = np.asarray(
                self._density(
                    jnp.asarray(xq[i : i + _CHUNK]),
                    jnp.asarray(yq[i : i + _CHUNK]),
                )
            )
        return out if out.size > 1 else out[0]

    def _density(self, xq, yq):
        z_x = ((self._x_dev[None, :] - xq[:, None]) * self.q_x) ** 2
        z_y = ((self._y_dev[None, :] - yq[:, None]) * self.q_y) ** 2
        return jnp.exp(-z_x - z_y).sum(axis=1) * self.norm

    def density(self, x, y):
        return self.__call__(x, y)

    @staticmethod
    def estimate_bandwidth(x, y):
        S = np.cov(x, y)
        p = S[0, 1] / np.sqrt(S[0, 0] * S[1, 1])
        return 1.06 * np.sqrt(np.diag(S) * (1 - p**2)) / (len(x) ** 0.2)
