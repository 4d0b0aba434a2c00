"""Floating-point policy helpers.

The samplers run in float32 by default and in float64 when x64 is enabled
(as the test-suite does, for numerical parity checks against the reference
implementation, which is float64 numpy throughout).
"""

import jax
import jax.numpy as jnp


def default_float():
    """The default floating dtype: float64 iff jax x64 mode is enabled."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
