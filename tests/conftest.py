"""Test harness: the tests run on the CPU, on an 8-device virtual platform,
so data-parallel and sharding paths are exercised without a GPU
(SURVEY.md §4).  What needs the card runs in chip_smoke.py."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import rslo_tpu.utils.jax_cache  # noqa: E402,F401  (persistent XLA cache)

assert jax.device_count() >= 8, jax.devices()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
