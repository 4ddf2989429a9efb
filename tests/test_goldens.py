"""Golden-image regression tests (deterministic CPU-jit renders).

Each golden covers a BASELINE.json config at test scale; regenerate with
`python scripts/make_goldens.py` after intentional behavior changes.
A small uint8 tolerance absorbs cross-version XLA fusion differences.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

from ptre.utils.image import read_ppm

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


def _golden_cases():
    import make_goldens

    return make_goldens.GOLDENS


@pytest.mark.parametrize("name", [
    "config1_sphere_light.ppm",
    "config2_cornell.ppm",
    "demo_pt.ppm",
    "demo_ortho.ppm",
    "demo_raster.ppm",
    "config3_trimesh_smooth.ppm",
    "config3_trimesh_flat.ppm",
    "config4_mixed_persp.ppm",
    "config4_mixed_ortho.ppm",
])
def test_golden(name):
    path = os.path.join(GOLDEN_DIR, name)
    assert os.path.exists(path), f"golden missing: run scripts/make_goldens.py"
    want = read_ppm(path).astype(np.int16)
    got = _golden_cases()[name]().astype(np.int16)
    assert got.shape == want.shape
    diff = np.abs(got - want)
    # identical up to ±2 uint8 steps on ≥99.5% of pixels, max 8
    frac_ok = (diff <= 2).mean()
    assert frac_ok >= 0.995, f"{name}: only {frac_ok:.4f} of pixels within 2"
    assert diff.max() <= 8, f"{name}: max diff {diff.max()}"
