"""inference_tpu — a Bayesian inference toolkit on JAX accelerators.

A from-scratch JAX/XLA rebuild with the capabilities of
``inference-tools``: adaptive MCMC samplers whose step loops compile to
``lax.scan`` and vmap over thousands of chains, Gaussian-process
regression / Bayesian optimisation / linear inversion with on-device
kernel assembly and autodiff hyperparameter gradients, density estimation,
likelihood/prior/posterior building blocks, and matplotlib diagnostics
(matplotlib is imported only by the plotting methods).
"""

__version__ = "0.1.0"

from .mcmc import (
    MetropolisChain,
    GibbsChain,
    PcaChain,
    EnsembleSampler,
    HamiltonianChain,
    NutsChain,
    ParallelTempering,
    ChainPool,
    Bounds,
)
from .models import (
    GaussianLikelihood,
    CauchyLikelihood,
    LogisticLikelihood,
    GaussianPrior,
    ExponentialPrior,
    UniformPrior,
    JointPrior,
    Posterior,
)
from .gp import (
    GpRegressor,
    GpOptimiser,
    GpLinearInverter,
)
from .pdf import GaussianKDE, UnimodalPdf, sample_hdi

__all__ = [
    "MetropolisChain",
    "GibbsChain",
    "PcaChain",
    "EnsembleSampler",
    "HamiltonianChain",
    "NutsChain",
    "ParallelTempering",
    "ChainPool",
    "Bounds",
    "GaussianLikelihood",
    "CauchyLikelihood",
    "LogisticLikelihood",
    "GaussianPrior",
    "ExponentialPrior",
    "UniformPrior",
    "JointPrior",
    "Posterior",
    "GpRegressor",
    "GpOptimiser",
    "GpLinearInverter",
    "GaussianKDE",
    "UnimodalPdf",
    "sample_hdi",
]
