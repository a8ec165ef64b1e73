"""Test env: CPU with 8 virtual devices, set BEFORE jax backends initialise.

Tests exercise the full pipeline (Pallas kernels run in interpret mode on
the CPU route, luisacomputegaussiansplatting_jax/backend.py) and the
multi-device sharding path on a virtual 8-device mesh. Tests that need
the GPU carry the ``gpu`` marker and skip inside a fixture when JAX has
no GPU; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402,F401


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere)")
