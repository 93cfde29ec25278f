"""The persistent compilation cache lands where JAX_COMPILATION_CACHE_DIR
says, and otherwise in the checkout's fixed .jax_cache."""

import os
import subprocess
import sys

import pytest

from hinge_tpu.utils.compile_cache import CHECKOUT_CACHE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, jax.numpy as jnp
from hinge_tpu.utils.compile_cache import enable_compile_cache
path = enable_compile_cache()
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7)).block_until_ready()
print("CACHE", path, jax.config.jax_compilation_cache_dir)
"""


def _probe(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    r = subprocess.run([sys.executable, "-c", _PROBE], capture_output=True,
                       text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    line = [l for l in r.stdout.splitlines() if l.startswith("CACHE ")][-1]
    return line.split()[1:]


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_location(env_set, tmp_path):
    if env_set:
        d = str(tmp_path / "jaxcache")
        path, config_dir = _probe(d)
        assert path == config_dir == d
        assert os.listdir(d), "nothing cached in JAX_COMPILATION_CACHE_DIR"
    else:
        path, config_dir = _probe(None)
        assert path == config_dir == CHECKOUT_CACHE
        assert CHECKOUT_CACHE == os.path.join(REPO, ".jax_cache")
        assert os.listdir(CHECKOUT_CACHE)
