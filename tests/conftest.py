"""Test harness: JAX's CPU backend with 8 virtual devices, unless told otherwise.

The reference has no tests at all (SURVEY.md §4); this harness upgrades its
self-verifying-run discipline (CPU readback + is-sorted scan,
``ParallelSort.cpp:326-352``) to a real pytest suite.  The suite runs on the
CPU: ``JAX_PLATFORMS`` defaults to ``cpu`` here, and 8 virtual CPU devices
let the mesh / all_to_all code run without several cards.  Tests marked
``gpu`` need an NVIDIA card and skip elsewhere; on a GPU host run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402  (after the environment above)
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20170101)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu on a GPU host")
    return jax.devices("gpu")[0]
