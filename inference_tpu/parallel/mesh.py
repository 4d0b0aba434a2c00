"""Device-mesh helpers for sharded sampling."""

import numpy as np
import jax
from jax.sharding import Mesh


def chain_mesh(n_devices: int = None, axis_name: str = "chains") -> Mesh:
    """A 1D mesh over the available devices for chain-batch sharding."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def tempering_mesh(n_rungs: int, n_devices: int = None) -> Mesh:
    """
    A 2D ('rungs', 'chains') mesh: temperature rungs on the first axis
    (swap collectives run along it), independent chains on the second.
    The GPUs of one host are joined all to all by NVLink, so any layout of
    the devices serves; the mesh follows the algorithm alone.
    """
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if n % n_rungs != 0:
        raise ValueError(
            f"n_rungs ({n_rungs}) must divide the device count ({n})"
        )
    grid = np.array(devices).reshape(n_rungs, n // n_rungs)
    return Mesh(grid, ("rungs", "chains"))
