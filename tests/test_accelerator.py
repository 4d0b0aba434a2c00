"""Entry-point set-up: the compilation cache's location, and an import of
the package that does not need matplotlib."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CACHE_PROBE = """
import jax
jax.config.update("jax_platforms", "cpu")
from inference_tpu.utils.accelerator import enable_compile_cache
path = enable_compile_cache()
print(path)
print(jax.config.jax_compilation_cache_dir)
"""


def _python(code, env):
    return subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("set_env", [True, False])
def test_compile_cache_location(set_env, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own reading of it stands;
    unset, the cache goes to the fixed <repo>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if set_env:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = _python(CACHE_PROBE, env)
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()
    want = str(tmp_path / "cache") if set_env else os.path.join(ROOT, ".jax_cache")
    assert returned == configured == want


def test_import_and_sample_without_matplotlib():
    """`import inference_tpu` and a ChainArray run work with matplotlib
    missing; only a plotting call needs it."""
    code = """
import sys
sys.modules["matplotlib"] = None
sys.modules["matplotlib.pyplot"] = None
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import inference_tpu
from inference_tpu.parallel import ChainArray
ca = ChainArray("hmc", lambda t: -0.5 * (t * t).sum(), np.zeros((4, 2)), seed=0)
ca.advance(20)
assert np.isfinite(ca.get_sample()).all()
chain = inference_tpu.GibbsChain(lambda t: -0.5 * (t * t).sum(),
                                 start=np.ones(2), display_progress=False)
chain.advance(200)
try:
    chain.plot_diagnostics()
except ImportError:
    print("plotting needs matplotlib")
"""
    out = _python(code, dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert "plotting needs matplotlib" in out.stdout
