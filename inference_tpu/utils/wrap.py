"""Adapters between user posterior callables and jitted sampler kernels.

The sampler step loops are compiled with ``jax.jit``/``lax.scan``, so the
user's ``posterior(theta) -> float`` callable must be jax-traceable. Posteriors
written against numpy (as reference users do) are automatically wrapped with
``jax.pure_callback`` so they still work (at host-call speed) inside the
compiled loops; traceable posteriors run natively on device at full speed.

Validation semantics mirror the reference
(reference: inference/mcmc/base.py:266-296): the posterior must be callable
and return a finite scalar for the start point.
"""

import numpy as np
import jax
import jax.numpy as jnp

from .dtypes import default_float


def is_traceable(fn, example) -> bool:
    """Check whether ``fn`` can be traced by jax on the example input."""
    try:
        out = jax.eval_shape(fn, jnp.asarray(example))
        return np.prod(out.shape, dtype=int) == 1
    except Exception:
        return False


def as_device_logp(fn, example):
    """
    Return a traceable scalar log-probability function. If ``fn`` is already
    jax-traceable it is returned (reshaped to a scalar); otherwise it is
    wrapped in a ``pure_callback`` that evaluates it on the host.
    """
    example = jnp.asarray(example, dtype=default_float())

    if is_traceable(fn, example):
        def logp(theta):
            return jnp.asarray(fn(theta), dtype=theta.dtype).reshape(())
        return logp

    result_shape = jax.ShapeDtypeStruct((), example.dtype)

    def host_eval(theta):
        return np.asarray(fn(np.asarray(theta)), dtype=theta.dtype).reshape(())

    def logp(theta):
        return jax.pure_callback(
            host_eval, result_shape, theta, vmap_method="sequential"
        )

    return logp


def validate_posterior(posterior, start, error_source: str = "MarkovChain"):
    """
    Eagerly validate the posterior callable on the start point: it must be
    callable and return a finite scalar (python float, numpy float or 0-d
    array — a relaxation of the reference's strict ``isinstance(prob, float)``
    check to admit jax scalar outputs).
    """
    if not callable(posterior):
        raise ValueError(
            f"[ {error_source} error ] The given 'posterior' is not a callable object."
        )

    prob = posterior(np.asarray(start, dtype=float))

    try:
        prob = float(prob)
    except (TypeError, ValueError):
        raise ValueError(
            f"[ {error_source} error ] The given 'posterior' must return a scalar "
            f"float-like value, but the returned value has type {type(prob)}."
        )

    if not np.isfinite(prob):
        raise ValueError(
            f"[ {error_source} error ] The given 'posterior' must return a finite "
            f"value for the given 'start' parameter values, but instead returns "
            f"{prob}."
        )
    return prob
