"""Shared fixtures for the test suite.

Device count: the k-machine-model tests (selection / knn / topk) need a
multi-shard mesh, so we ask the CPU platform for 8 placeholder devices —
deliberately NOT the dry-run's 512 (launch/dryrun.py sets its own flag in
its own process; smoke tests here are mesh-free and indifferent to the
host device count).
"""

import os

if "--xla_force_host_platform_device_count" not in os.environ.get(
        "XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                               + os.environ.get("XLA_FLAGS", ""))
os.environ.setdefault("REPRO_KERNEL_MODE", "interpret")

import jax  # noqa: E402,F401  (import order: flags first)
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro.parallel.compat import make_mesh  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture(scope="session")
def mesh8():
    return make_mesh((8,), ("x",))


@pytest.fixture(scope="session")
def mesh42():
    return make_mesh((4, 2), ("data", "model"))


@pytest.fixture()
def rng():
    return np.random.default_rng(0)
