"""Test env: an 8-device virtual CPU mesh, set up BEFORE jax is imported.

Multi-device sharding is validated here on virtual CPU devices, per the
project's test strategy (SURVEY.md §4); the GPU kernels run through the
Pallas interpreter. Tests that need the card carry the ``gpu`` marker and
skip elsewhere; on a GPU machine run them with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

from entreepy_tpu.utils.compile_cache import use_compile_cache  # noqa: E402

# Persist compiled executables across test runs (first run pays the XLA
# compile cost; subsequent runs are fast).
use_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

DATA = Path(__file__).parent / "data"


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time,
    never at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU (run with JAX_PLATFORMS=cuda -m gpu)")


@pytest.fixture(scope="session")
def tiny_text() -> bytes:
    return (DATA / "test.txt").read_bytes()


@pytest.fixture(scope="session")
def macbeth() -> bytes:
    return (DATA / "nice.shakespeare.txt").read_bytes()


@pytest.fixture(scope="session")
def midsummer() -> bytes:
    return (DATA / "a_midsummer_nights_dream.txt").read_bytes()
