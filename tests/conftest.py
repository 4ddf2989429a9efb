"""Test configuration: CPU-jit with 8 virtual devices for multi-device tests.

Forcing the host platform and splitting it into 8 virtual devices lets the
`Mesh`/`shard_map` paths compile and execute exactly as on several cards.
``JAX_PLATFORMS`` is only defaulted to ``cpu``: a process that already
holds a GPU (``python chip_smoke.py`` runs ``pytest -m gpu`` in-process) or
sets ``JAX_PLATFORMS=cuda`` keeps it.

Tests marked ``gpu`` need the card; the fixture below skips them on any
other platform, deciding per test, never at import.
"""

import os
import sys

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip ``@pytest.mark.gpu`` tests unless JAX's first device is a GPU."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
