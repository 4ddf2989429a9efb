"""Gradient conditioning across rematerialization contexts — the round-4
PERF.md caveat turned into a tested contract (round-4 VERDICT directive #7).

Round-4 measured that `jax.checkpoint` moved individual GEOMETRY gradient
entries by 10-40 % (materials/sky held at 0.1 %) and attributed it to
curvature amplifiers. The round-5 bisection found the real mechanism:
under remat the backward re-linearizes the bounce chain's heavy-tailed
Jacobians at an ulp-shifted recompute point (`everything_saveable` agreed
to 1e-8; ANY recompute diverged at the percent level, with curvature
clamps and branch pins active). The fix is `ops.gradsafe.remat_policy` +
`remat_pin`: the O(R)-float ray-geometry state (primary rays, hit t/p/n,
scatter direction) and every discrete branch decision are SAVED residuals,
so only the O(R*P) sweep and the shading chain recompute — from bit-equal
linearization points.

Contract pinned here, at BASELINE config 2 (cornell spheres, the scene
with silhouette-grazing wall hits), remat'd vs plain sample scan:

  * geometry/camera gradient leaves: per-leaf norm-relative error <= 5e-2
    (measured 1.2-2.9 % — down from 24-43 % before the pins)
  * material/sky gradient leaves:    per-leaf norm-relative error <= 1e-3
    (measured ~1e-4)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptre.models import demo
from ptre.ops import camera as cam_ops, gradsafe, rng
from ptre.parallel import sharding as sh
from ptre.render import train
from ptre.utils.config import RenderConfig

pytestmark = pytest.mark.slow

W = H = 64
SPP = 4

#: per-leaf norm-relative agreement bounds (module docstring)
GEOMETRY_BOUND = 5e-2
SMOOTH_BOUND = 1e-3
GEOMETRY_LEAVES = ("sph_center", "sph_radius", "transforms",
                   "cam_position", "cam_forward", "cam_fov")


def test_remat_geometry_gradients_agree():
    scn = demo.cornell_spheres_scene()
    pkt = scn.build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H, max_depth=4)
    params = sh.differentiable_params(pkt, cam)
    key = rng.key_for(5)
    target = jnp.zeros((W * H, 3), jnp.float32)

    def loss(par, k, remat):
        def body(acc, s):
            return acc + train.sample_color(par, pkt, cam, cfg,
                                            rng.fold(k, s)), None

        b = (jax.checkpoint(body, policy=gradsafe.remat_policy)
             if remat else body)
        acc, _ = jax.lax.scan(b, jnp.zeros_like(target), jnp.arange(SPP))
        return jnp.mean((acc / SPP - target) ** 2)

    g_plain = jax.jit(jax.grad(lambda p, k: loss(p, k, False)))(params, key)
    g_remat = jax.jit(jax.grad(lambda p, k: loss(p, k, True)))(params, key)

    for kk in g_plain:
        a, b = np.asarray(g_remat[kk]), np.asarray(g_plain[kk])
        assert np.isfinite(a).all() and np.isfinite(b).all(), kk
        nb = np.linalg.norm(b)
        if nb == 0.0:
            assert np.linalg.norm(a) == 0.0, kk
            continue
        rel = np.linalg.norm(a - b) / nb
        bound = (GEOMETRY_BOUND if kk in GEOMETRY_LEAVES else SMOOTH_BOUND)
        assert rel <= bound, (kk, rel, bound)
