"""Where the persistent XLA compilation cache lands: JAX_COMPILATION_CACHE_DIR
when it is set, else the fixed `<checkout>/.jax_cache`. Each case runs in a
fresh process, since JAX fixes its cache when it first compiles."""

import os
import pathlib
import subprocess
import sys

import neptune_tpu

CHECKOUT = pathlib.Path(neptune_tpu.__file__).resolve().parent.parent

PROBE = """
import jax, jax.numpy as jnp
from neptune_tpu.config import setup_persistent_cache
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
d = setup_persistent_cache()
jax.jit(lambda x: x * 3.0 + 1.0)(jnp.arange(7.0)).block_until_ready()
print(d)
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(cache_env):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(cache_env)
    r = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=CHECKOUT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.split()[-2:]


def test_cache_follows_env(tmp_path):
    d, cfg = _probe({"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert d == cfg == str(tmp_path)
    assert any(tmp_path.iterdir())


def test_cache_defaults_to_checkout():
    d, cfg = _probe({})
    cache = CHECKOUT / ".jax_cache"
    assert d == cfg == str(cache)
    assert cache.is_dir() and any(cache.iterdir())
