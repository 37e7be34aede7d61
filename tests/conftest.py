"""Test configuration: the CPU with a virtual 8-device platform.

Multi-device sharding tests run on simulated CPU devices
(``--xla_force_host_platform_device_count=8``) — the standard way to test
mesh code without several accelerators (SURVEY.md §4). The suite runs on
the CPU unless ``JAX_PLATFORMS`` names another platform: tests marked
``gpu`` need the card and run with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``; elsewhere they skip.
"""

import os
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def fixture_data():
    """The reference test fixture (test/datatest.jld2 → npz): x (1000, 5),
    θ (1000, 1) with θ ∈ {−1, 2}."""
    path = os.path.join(os.path.dirname(__file__), "fixtures", "datatest.npz")
    dat = np.load(path)
    return dat["x"], dat["theta"]


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Tests marked ``gpu`` compile for the card; decided per test, at run
    time, so every worker collects the same tests."""
    if request.node.get_closest_marker("gpu") is not None:
        if jax.devices()[0].platform != "gpu":
            pytest.skip("needs an NVIDIA GPU: run "
                        "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
