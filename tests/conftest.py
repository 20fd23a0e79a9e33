"""Test configuration: run everything on the CPU, as 8 virtual devices.

The tests need no accelerator.  XLA's host-platform device emulation gives
the CPU backend 8 devices, so the mesh and sharding tests exercise the
same shard_map programs the pipeline runs on several GPUs (SURVEY.md §4).
The fused GPU kernels are tested in the Pallas interpreter; on the card
itself they are checked by ``chip_smoke.py`` (``--devices 4`` for the
four-GPU path).
"""

import os

# Must be set before jax initializes its backends.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)
