"""Test configuration: run JAX on a simulated 8-device CPU mesh.

Multi-device sharding logic is validated without accelerators by forcing the
host platform and splitting it into 8 virtual devices (SURVEY.md §4). The
device-count XLA flag is read lazily at backend init, so setting it here
works.

Tests marked ``gpu`` need an NVIDIA card; they skip here and are run on the
card with ``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``. Only that
explicit ``JAX_PLATFORMS`` leaves the platform to JAX; otherwise the CPU is
forced.
"""

import os

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

ON_CPU = os.environ.get("JAX_PLATFORMS", "cpu") == "cpu"
if ON_CPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")
    assert jax.device_count() == 8, (
        f"expected 8 virtual CPU devices, got {jax.device_count()} on "
        f"{jax.devices()[0].platform}")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def card():
    """The GPU, for tests marked ``gpu``; skips where there is none. The
    test runs at full matmul precision (float32 may mean TF32 otherwise)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda python -m "
                    "pytest tests/ -m gpu")
    with jax.default_matmul_precision("highest"):
        yield jax.devices()[0]
