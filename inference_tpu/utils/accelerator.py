"""Accelerator set-up shared by the entry-point scripts (``chip_smoke.py``,
``bench.py``, ``benchmarks/run_all.py``): the persistent compilation
cache, the GPU requirement, and the card's identity for the records."""

import os
import subprocess

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache at one fixed place and
    return it. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it
    itself and nothing is changed here; otherwise the cache goes to
    ``<repo>/.jax_cache`` (a fixed path, so later runs find it)."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(script: str):
    """The JAX devices, or ``SystemExit`` (non-zero) when the default
    backend is not a GPU: a measurement never falls back to the CPU."""
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"[ {script} ] needs an NVIDIA GPU, but JAX's default backend "
            f"is '{platform}' ({devices[0].device_kind}); nothing was "
            f"measured."
        )
    return devices


def device_record(devices) -> dict:
    """Platform, kind and count of ``devices``, as JAX reports them."""
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_identity() -> str:
    """The cards' names and power limits, one line per card, exactly as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (a child process that does not touch JAX)."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip()
