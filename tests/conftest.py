"""Test harness: the suite runs on an 8-virtual-device CPU mesh.

The platform is fixed through jax.config before any backend is initialized,
so the multi-device sharding paths run on 8 virtual CPU devices. Tests
marked ``gpu`` need a card: run them on a GPU machine with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/

where the ``gpu`` fixture finds the card; everywhere else it skips them.

The reference has no fake multi-device backend at all (its pmap paths are
only exercised on real GPUs, see SURVEY.md §4); this conftest is the missing
piece that lets the full sharded training path run in CI.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The first GPU, or a skip when JAX sees none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's platform is {devices[0].platform!r}")
    return devices[0]
