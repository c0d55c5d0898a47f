"""Test configuration.

Tests run on CPU with 8 virtual devices and float64 enabled — the reference's
numerical contracts are double precision (PETSc scalars), and the multi-chip
sharding tests need a virtual mesh (SURVEY.md §4: the answer to
"multi-node without a real cluster" is
`--xla_force_host_platform_device_count=N`).

Env vars must be set before JAX initializes, hence at conftest import time.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# Pin the 8-device virtual CPU mesh even where a GPU is visible.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
