"""Test configuration: the CPU with 8 virtual devices, unless told otherwise.

Multi-device sharding tests need more than one device, so the tests run
on the CPU backend with 8 virtual devices
(xla_force_host_platform_device_count); Pallas kernels run there in
interpret mode. ``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``
runs the tests marked ``gpu`` on an NVIDIA card (chip_smoke.py runs
them too); everywhere else they skip.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)


@pytest.fixture
def gpu():
    """Skip unless JAX runs on an NVIDIA GPU (decided at run time)."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` "
                    "on the card")
