"""Finite-difference checks for EVERY leaf of `differentiable_params`.

BASELINE config 4 names "differentiable camera/material/transform params";
this battery pins d(mean image)/d(theta) against central finite differences
for each parameter leaf: per-drawcall transforms (and through them triangle
geometry), sphere center/radius, material albedo/sigma/emissive strength,
sky endpoints, camera position/forward/fov.

Visibility-affecting leaves use loose tolerances (the detached-visibility
estimator drops silhouette terms that FD includes); shading-only leaves
match tightly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptre.models import demo
from ptre.ops import camera as cam_ops, integrator, rng
from ptre.parallel import sharding as sh
from ptre.render import pathtracer as pt
from ptre.utils.config import RenderConfig

# slow tier: full-matrix gradient checks (minutes of CPU autodiff) (run with `pytest -m slow`)
pytestmark = pytest.mark.slow

W = H = 8


def _setup():
    scn = demo.reference_demo_scene(8, 4)
    # a DIFFUSE (Oren-Nayar) cube in frame: transform gradients only flow
    # through diffuse shading (an emissive hit contributes a constant
    # factor), so the demo's emissive-only cube would give zero grads
    from ptre.models.scene import Model

    scn.add_model("dcube", Model("cube", material=0))
    scn.get_model("dcube").set_transforms(0.9, 0.0, (-0.9, 0.5, 0.0))
    pkt = scn.build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H, clamp_samples=False)
    key = rng.key_for(10)
    px, py = pt.pixel_grid(H, W)
    return pkt, cam, cfg, key, px, py


_PKT, _CAM, _CFG, _KEY, _PX, _PY = _setup()
_PARAMS = sh.differentiable_params(_PKT, _CAM)


def _loss(params):
    pkt, cam = sh._apply_params(params, _PKT, _CAM)
    o, d = cam_ops.get_rays(cam, _PX, _PY, jnp.zeros((W * H, 2)))
    c = integrator.trace(_KEY, o, d, pkt, _CFG)
    return jnp.mean(c)


_GRADS = jax.grad(_loss)(_PARAMS)
# the DIFFUSE cube's drawcall row for transform perturbations (the one
# translated to x = -0.9)
_WALL_DC = int(np.where(np.asarray(_PKT.transforms)[:, 3, 0] == -0.9)[0][0])


def _fd(leaf, idx, eps):
    def at(delta):
        p = dict(_PARAMS)
        p[leaf] = _PARAMS[leaf].at[idx].add(delta)
        return float(_loss(p))

    return (at(eps) - at(-eps)) / (2 * eps)


CASES = [
    # (leaf, index, eps, rtol, atol, visibility-affecting)
    ("transforms", (_WALL_DC, 3, 0), 1e-3, 0.1, 2e-3, True),   # translate x
    ("transforms", (_WALL_DC, 0, 0), 1e-3, 0.1, 2e-3, True),   # scale x
    ("sph_center", (0, 1), 1e-3, 0.1, 2e-3, True),
    ("sph_center", (1, 0), 1e-3, 0.1, 2e-3, True),
    ("sph_radius", (0,), 1e-3, 0.1, 1e-3, True),
    ("mat_albedo", (0, 0), 1e-3, 2e-2, 1e-4, False),
    ("mat_param", (0,), 1e-3, 2e-2, 1e-4, False),   # Oren-Nayar sigma
    ("mat_param", (1,), 1e-3, 2e-2, 1e-4, False),   # emissive strength
    ("sky_bottom", (2,), 1e-3, 2e-2, 1e-4, False),
    ("sky_top", (0,), 1e-3, 2e-2, 1e-4, False),
    ("cam_position", (2,), 1e-3, 0.1, 2e-3, True),
    ("cam_forward", (1,), 1e-3, 0.1, 2e-3, True),
    ("cam_fov", (), 1e-2, 0.1, 2e-3, True),
]


@pytest.mark.parametrize("leaf,idx,eps,rtol,atol,vis", CASES,
                         ids=[f"{c[0]}{list(c[1])}" for c in CASES])
def test_gradient_matches_fd(leaf, idx, eps, rtol, atol, vis):
    g = float(_GRADS[leaf][idx]) if idx != () else float(_GRADS[leaf])
    fd = _fd(leaf, idx, eps)
    np.testing.assert_allclose(g, fd, rtol=rtol, atol=atol)


def test_gradients_are_nontrivial():
    """Every leaf must receive a nonzero gradient somewhere."""
    for leaf, g in _GRADS.items():
        assert float(jnp.max(jnp.abs(g))) > 1e-6, leaf
