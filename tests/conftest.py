"""Test configuration.

Tests run on the CPU backend, split into 8 virtual devices so sharded
code paths compile and execute without a GPU; the graph-SW fill runs as
its plain XLA engine there (ops/multi_sw.py select_engine). The CUDA
kernel is checked on the card by ``python chip_smoke.py`` and by the
tests marked ``gpu``, which skip here.

The persistent compile cache is off: CPU executables compiled here must
never land in the checkout's cache directory and travel to the machine
with the card.
"""
import os

# Must be set before jax initializes a backend. The tests marked gpu run
# on the card with JAX_PLATFORMS=cuda set by the caller.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["PARAGRAPH_TPU_NO_CACHE"] = "1"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402

REFERENCE = "/root/reference"


@pytest.fixture(scope="session")
def reference_dir():
    return REFERENCE


@pytest.fixture(scope="session")
def roundtrip_dir():
    return os.path.join(REFERENCE, "share", "test-data", "round-trip-genotyping")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU. Decided at
    run time, never at import, so every xdist worker collects the same
    tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (on the card: JAX_PLATFORMS=cuda "
                    "python -m pytest tests/test_cuda_fill.py -m gpu)")
    return jax.devices()[0]
