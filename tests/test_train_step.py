"""The two-pass constant-memory MSE gradient == the monolithic gradient.

`render.train.two_pass_mse_step` is the schedule that makes BASELINE
config 4 (1080p / 64 spp / 16k tris) trainable on one chip; its exactness
claim (the cotangent 2(M-T)/(N*S) factors out of the sample sum) is the
whole contract — so pin it against the monolithic remat'd scan at a small
shape, on the staged CPU path, in the default tier.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptre.models import demo
from ptre.ops import camera as cam_ops, rng
from ptre.parallel import sharding as sh
from ptre.render import train
from ptre.utils.config import RenderConfig

W = H = 16
SPP = 4


@pytest.fixture(scope="module")
def setup():
    scn = demo.reference_demo_scene(6, 4)
    pkt = scn.build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    params = sh.differentiable_params(pkt, cam)
    key = rng.key_for(3)
    # a non-trivial target so the cotangent isn't symmetric around zero
    tkey = rng.fold(key, 0x7A)
    target = jax.random.uniform(tkey, (W * H, 3), jnp.float32, 0.0, 0.5)
    return params, pkt, cam, cfg, params, key, target


def test_two_pass_matches_monolithic(setup):
    params, pkt, cam, cfg, _, key, target = setup
    l1, g1 = train.mse_step(params, pkt, cam, target, key, cfg, spp=SPP)
    l2, g2 = train.two_pass_mse_step(params, pkt, cam, target, key, cfg,
                                     spp=SPP)
    assert np.allclose(float(l1), float(l2), rtol=1e-6, atol=1e-9)
    flat1 = jax.tree.leaves(g1)
    flat2 = jax.tree.leaves(g2)
    assert len(flat1) == len(flat2)
    for a, b in zip(flat1, flat2):
        a, b = np.asarray(a), np.asarray(b)
        assert np.isfinite(a).all() and np.isfinite(b).all()
        # identical samples, identical cotangent algebra — only summation
        # order differs (remat'd scan accumulates loss-side, two-pass
        # accumulates vjp-side), so agreement is float-roundoff tight
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-7)


def test_two_pass_loss_is_image_mse(setup):
    params, pkt, cam, cfg, _, key, target = setup
    l2, _ = train.two_pass_mse_step(params, pkt, cam, target, key, cfg,
                                    spp=SPP)
    acc = jnp.zeros((W * H, 3), jnp.float32)
    for s in range(SPP):
        acc = acc + train.sample_color(params, pkt, cam, cfg,
                                       rng.fold(key, s))
    ref = float(jnp.mean((acc / SPP - target) ** 2))
    assert np.allclose(float(l2), ref, rtol=1e-6, atol=1e-9)
