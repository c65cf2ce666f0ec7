"""Test configuration: an 8-device virtual CPU mesh, set before first use.

This is the standard JAX trick for testing multi-device sharding without
hardware (SURVEY.md §4): the default tier runs on CPU with 8 fake devices so
`shard_map`/`pjit` paths execute real collectives.

Tests marked `gpu` need the card; they are deselected by default (pytest.ini)
and run on a GPU machine with

    SQRTLM_TEST_GPU=1 python -m pytest tests/ -q -m gpu

Whether a card is present is decided inside the `gpu_device` fixture, never
while a module is imported.
"""

import os
import sys

import pytest

_USE_GPU = os.environ.get("SQRTLM_TEST_GPU", "") == "1"

if not _USE_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _USE_GPU:
    # The default tier is a CPU run even on a machine with a card.
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sqrtlm_slam_tpu.utils.cache import configure_jax  # noqa: E402

configure_jax()


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU (run with SQRTLM_TEST_GPU=1 -m gpu)")
    return devices[0]
