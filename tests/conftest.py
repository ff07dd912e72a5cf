"""Test harness: an 8-device virtual CPU mesh, so multi-device sharding
logic is exercised without accelerators (SURVEY.md §4), and x64, so
high-precision parity oracles can run in float64.

The suite runs on the CPU whatever JAX_PLATFORMS says, except when it names
the GPU (``cuda`` or ``gpu``): then the ``gpu``-marked tests run on the
card, e.g. ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

if os.environ.get("JAX_PLATFORMS") not in ("cuda", "gpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first JAX device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform!r}")
    return dev
