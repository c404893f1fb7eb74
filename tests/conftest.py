"""Test env: force the JAX CPU backend with 8 virtual devices so multi-device
sharding tests run without an accelerator (SURVEY.md §4).  The GPU checks
are chip_smoke.py's phases, run on the card itself."""

import os

# Override both the env (for subprocesses) and the live config, so the
# tests run on the virtual 8-device CPU backend even where a GPU is present.
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def rgb_image(rng):
    return rng.integers(0, 256, size=(97, 123, 3), dtype=np.uint8)


@pytest.fixture
def rgba_image(rng):
    return rng.integers(0, 256, size=(64, 80, 4), dtype=np.uint8)
