"""Shared host-side facade for all samplers.

JAX rebuild of the reference ``MarkovChain`` ABC
(reference: inference/mcmc/base.py:14-296). The user-facing API is preserved
(``advance``, ``run_for``, ``get_parameter/get_probabilities/get_sample`` with
burn/thin slicing, ``get_marginal``, ``get_interval``, plot wrappers, the
removed burn/thin attribute errors), but instead of a Python ``take_step``
loop, advancement runs compiled ``lax.scan`` chunks on device:

- ``advance(m)`` splits the run into 100 progress groups like the reference
  (reference: base.py:31-46), each group executed as a handful of
  power-of-two-length scans so the set of compiled program shapes is small
  and reused across calls;
- chain history is accumulated in host numpy arrays (the reference's growing
  Python lists, reference: gibbs.py:28,158-159), transferred once per chunk.
"""

from abc import ABC, abstractmethod
from copy import copy
from time import time

import numpy as np

from ..utils.progress import ChainProgressPrinter
from ..utils.wrap import validate_posterior

_MAX_CHUNK = 2048


class MarkovChain(ABC):
    chain_length: int
    n_parameters: int
    ProgressPrinter: ChainProgressPrinter

    @abstractmethod
    def get_parameter(self, index: int, burn: int = 1, thin: int = 1) -> np.ndarray:
        pass

    @abstractmethod
    def get_probabilities(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        pass

    @abstractmethod
    def get_sample(self, burn: int = 1, thin: int = 1) -> np.ndarray:
        pass

    @abstractmethod
    def _run_chunk(self, n: int):
        """Advance the chain ``n`` steps on device and append the history."""

    def take_step(self):
        """Advance the chain by a single step."""
        self._advance_n(1)

    def _advance_n(self, n: int):
        """
        Advance ``n`` steps using power-of-two scan chunks (bounded compile
        cache: each distinct chunk length compiles once per sampler config).
        """
        remaining = int(n)
        while remaining > 0:
            chunk = min(1 << (remaining.bit_length() - 1), _MAX_CHUNK)
            self._run_chunk(chunk)
            remaining -= chunk

    def advance(self, m: int):
        """
        Advances the chain by taking ``m`` new steps.

        :param int m: Number of steps the chain will advance.
        """
        t_start = time()
        if not getattr(self, "display_progress", True):
            # no progress display: run the minimal set of scan chunks
            # (every host round-trip costs device latency)
            self._advance_n(m)
            self.ProgressPrinter.percent_final(t_start, m)
            return

        k = 100  # divide chain steps into k progress groups
        group = m // k
        for j in range(k):
            if group > 0:
                self._advance_n(group)
            self.ProgressPrinter.percent_progress(t_start, j, k)
        if m % k != 0:
            self._advance_n(m % k)
        self.ProgressPrinter.percent_final(t_start, m)

    def run_for(self, minutes=0, hours=0, days=0):
        """
        Advances the chain for a chosen amount of wall-clock time
        (reference: base.py:48-73).

        :param minutes: number of minutes for which to run the chain.
        :param hours: number of hours for which to run the chain.
        :param days: number of days for which to run the chain.
        """
        update_interval = 20  # small initial guess for the update interval
        start_length = copy(self.chain_length)

        run_time = ((days * 24.0 + hours) * 60.0 + minutes) * 60.0
        start_time = time()
        current_time = start_time
        end_time = start_time + run_time
        steps_taken = 0

        while current_time < end_time:
            self._advance_n(update_interval)
            steps_taken = self.chain_length - start_length
            current_time = time()
            # aim for roughly one update per second, rounded to a power of two
            # so the set of compiled chunk shapes stays bounded
            rate = max(int(steps_taken / max(current_time - start_time, 1e-9)), 1)
            update_interval = 1 << (rate.bit_length() - 1)
            self.ProgressPrinter.countdown_progress(end_time, steps_taken)
        self.ProgressPrinter.countdown_final(run_time, steps_taken)

    def get_marginal(self, index: int, burn: int = 1, thin: int = 1, unimodal=False):
        """
        Estimate the 1D marginal distribution of a chosen parameter, returning
        a ``GaussianKDE`` (default) or ``UnimodalPdf`` density estimator
        (reference: base.py:75-107).
        """
        from ..pdf import GaussianKDE, UnimodalPdf

        samples = self.get_parameter(index, burn=burn, thin=thin)
        return UnimodalPdf(samples) if unimodal else GaussianKDE(samples)

    def get_interval(
        self, interval: float = 0.95, burn: int = 1, thin: int = 1, samples: int = None
    ):
        """
        Return the samples from the chain which lie inside a chosen
        highest-density interval (reference: base.py:109-162).
        """
        probs = self.get_probabilities(burn=burn)
        if samples is not None:
            thin = max(probs.size // samples, 1)

        sample = self.get_sample(burn=burn, thin=thin)
        probs = probs[::thin]

        sorter = probs.argsort()
        sample = sample[sorter, :]
        probs = probs[sorter]
        cutoff = int(probs.size * (1 - interval))
        sample = sample[cutoff:, :]
        probs = probs[cutoff:]

        if samples is not None:
            n_trim = probs.size - samples
            if n_trim > 0:
                keep = np.sort(np.random.permutation(probs.size)[n_trim:])
                sample = sample[keep, :]
                probs = probs[keep]

        return sample, probs

    def matrix_plot(self, params=None, burn: int = 0, thin: int = 1, **kwargs):
        """
        Construct a matrix plot of 1D and 2D marginal distributions
        (see ``inference_tpu.plotting.matrix_plot``).
        """
        from ..plotting import matrix_plot

        self.__plot_checks(burn, thin, "matrix")
        params = params if params is not None else range(self.n_parameters)
        samples = [self.get_parameter(i, burn=burn, thin=thin) for i in params]
        matrix_plot(samples, **kwargs)

    def trace_plot(self, params=None, burn: int = 0, thin: int = 1, **kwargs):
        """
        Construct a trace plot of parameter values against step number
        (see ``inference_tpu.plotting.trace_plot``).
        """
        from ..plotting import trace_plot

        self.__plot_checks(burn, thin, "trace")
        params = params if params is not None else range(self.n_parameters)
        samples = [self.get_parameter(i, burn=burn, thin=thin) for i in params]
        trace_plot(samples, **kwargs)

    def __plot_checks(self, burn: int, thin: int, plot_type: str):
        if self.chain_length < 2:
            raise ValueError(
                f"[ {self.__class__.__name__} error ] Cannot generate the "
                f"{plot_type} plot as no samples have been produced - current "
                f"chain length is {self.chain_length}."
            )
        reduced_length = max(self.chain_length - burn - 1, 0) // thin + 1
        if reduced_length < 2:
            raise ValueError(
                f"[ {self.__class__.__name__} error ] The given values of 'burn' "
                f"and 'thin' leave insufficient samples to generate the "
                f"{plot_type} plot. Number of samples after burn / thin is "
                f"{reduced_length}."
            )

    @property
    def burn(self):
        self.__burn_thin_error()

    @burn.setter
    def burn(self, val):
        self.__burn_thin_error()

    @property
    def thin(self):
        self.__burn_thin_error()

    @thin.setter
    def thin(self, val):
        self.__burn_thin_error()

    def __burn_thin_error(self):
        raise AttributeError(
            f"[ {self.__class__.__name__} error ] The 'burn' and 'thin' instance "
            f"attributes of mcmc samplers were removed - burn and thin values "
            f"should now be passed explicitly to any methods with 'burn' and "
            f"'thin' keyword arguments."
        )

    def _validate_posterior(self, posterior, start):
        validate_posterior(posterior, start, error_source=self.__class__.__name__)
