"""Test harness configuration.

Tests run on the CPU with a virtual 8-device mesh (SURVEY.md section 4):
sharding logic is validated without accelerators, and everything is
deterministic.  The env vars must be set before jax is imported anywhere.

Tests that need an NVIDIA GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them when no GPU is present; run them
on a GPU machine with ``python -m pytest -m gpu tests/`` (chip_smoke.py
runs them in-process).
"""

import os

if os.environ.get("PATHTRACER_TEST_PLATFORM") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

# Persistent compile cache: $JAX_COMPILATION_CACHE_DIR if set, else the
# checkout's fixed .jax_cache/ (utils/compile_cache.py).
from pathtracer_tpu.utils import compile_cache  # noqa: E402

compile_cache.configure()


@pytest.fixture
def rng_np():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU")
    return gpus[0]
