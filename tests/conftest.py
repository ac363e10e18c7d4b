"""Test configuration: force an 8-device virtual CPU mesh.

Tests validate semantics and sharding on the host CPU; runs on the GPU go
through `chip_smoke.py`, `bench.py` and the `gpu`-marked tests. The
platform is forced to CPU before any test touches jax, except in a
card-only run (`python -m pytest -m gpu tests/`), which keeps JAX's
default device."""

import os

import jax
import numpy as np
import pytest


def pytest_configure(config):
    if config.getoption("markexpr") == "gpu":
        return
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    )
    os.environ["JAX_PLATFORMS"] = "cpu"
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)
