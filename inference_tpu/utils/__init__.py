from .bounds import Bounds, reflect_to_bounds
from .ess import effective_sample_size, effective_sample_size_batched
from .diagnostics import split_rhat, rank_normalized_rhat
from .progress import ChainProgressPrinter
from .random import make_key
from .dtypes import default_float
from .wrap import (
    as_device_logp,
    validate_posterior,
    is_traceable,
)
from .profiling import device_trace, PhaseTimer

__all__ = [
    "Bounds",
    "reflect_to_bounds",
    "effective_sample_size",
    "effective_sample_size_batched",
    "split_rhat",
    "rank_normalized_rhat",
    "ChainProgressPrinter",
    "make_key",
    "default_float",
    "as_device_logp",
    "validate_posterior",
    "is_traceable",
    "device_trace",
    "PhaseTimer",
]
