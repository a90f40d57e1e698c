"""Test configuration: force an 8-virtual-device CPU backend.

Multi-device sharding logic is tested without hardware on 8 virtual CPU
devices (SURVEY.md §4c) — the fake-backend capability the reference lacks.
On the CPU every op runs its plain path, and tests that ask for a Pallas
kernel (impl="kernel") get it in interpret mode (utils/platform.py).
Tests that need the card carry the ``gpu`` marker and skip here; they run
on the card through ``python chip_smoke.py``.

``jax.config.update`` is used rather than environment variables because a
pytest plugin may import jax before this file runs.
"""

import os

os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (run by chip_smoke.py)")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
