"""Test configuration: JAX on a virtual 8-device CPU mesh in float64.

The tests validate numerics (float64 parity with the reference algorithms)
and multi-device sharding on the CPU backend, per SURVEY.md §4(f).  The
CPU is the default backend; JAX_PLATFORMS picks another.  Tests marked
`gpu` need an NVIDIA GPU and skip without one; on a machine with the card
run them with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/`.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has no GPU backend."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs an NVIDIA GPU (JAX found none)")
