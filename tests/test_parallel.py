"""Multi-chip sharding tests on a virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptre.models import demo
from ptre.ops import camera as cam_ops, integrator, rng
from ptre.parallel import sharding as sh
from ptre.render import pathtracer as pt
from ptre.utils.config import RenderConfig

H, W = 16, 16


@pytest.fixture(scope="module")
def scene_setup():
    scn = demo.reference_demo_scene(8, 4)
    pkt = scn.build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    return pkt, cam, cfg


def test_devices_available():
    assert len(jax.devices()) == 8


def test_shard_render_step_dp(scene_setup):
    pkt, cam, cfg = scene_setup
    mesh = sh.make_mesh((8, 1))
    accum = pt.AccumState.create(H, W)
    out = sh.shard_render_step(mesh, pkt, cam, accum, rng.key_for(0), cfg, spp=2)
    assert out.linear.shape == (H, W, 3)
    assert int(out.frame) == 2
    a = np.asarray(out.linear)
    assert np.all(np.isfinite(a)) and a.min() >= 0.0 and a.max() <= 1.0
    assert a.max() > 0.05
    # deterministic
    out2 = sh.shard_render_step(mesh, pkt, cam, accum, rng.key_for(0), cfg, spp=2)
    np.testing.assert_array_equal(np.asarray(out.linear), np.asarray(out2.linear))


def test_shard_render_step_dp_sp(scene_setup):
    pkt, cam, cfg = scene_setup
    mesh = sh.make_mesh((4, 2))
    accum = pt.AccumState.create(H, W)
    out = sh.shard_render_step(mesh, pkt, cam, accum, rng.key_for(1), cfg, spp=4)
    assert int(out.frame) == 4
    a = np.asarray(out.linear)
    assert np.all(np.isfinite(a)) and a.max() <= 1.0 and a.max() > 0.05


def test_shard_render_matches_single_device_emulation(scene_setup):
    """The sharded render must equal a hand replay of each shard's math."""
    pkt, cam, cfg = scene_setup
    mesh = sh.make_mesh((4, 2))
    accum = pt.AccumState.create(H, W)
    key = rng.key_for(7)
    out = sh.shard_render_step(mesh, pkt, cam, accum, key, cfg, spp=4)

    # emulate the default STRIDED row assignment: chip dp_i owns image rows
    # dp_i, dp_i+4, ... and its shard slab stores them contiguously
    rows = H // 4
    local_spp = 4 // 2
    lin_full = np.zeros((H, W, 3), np.float32)
    for dp_i in range(4):
        per_sp = []
        for sp_i in range(2):
            lkey = rng.fold(key, dp_i * 131071 + sp_i)
            lin = np.zeros((rows, W, 3), np.float32)
            n = 0
            for s in range(local_spp):
                n += 1
                skey = rng.fold(rng.fold(lkey, s), n)
                img = np.asarray(
                    sh._sample_rows(skey, pkt, cam, cfg, float(dp_i), rows, 4)
                ).reshape(rows, W, 3)
                nf = np.float32(n)
                lin = (img / nf + lin * ((nf - 1.0) / nf)).astype(np.float32)
            per_sp.append(lin)
        lin_full[dp_i * rows : (dp_i + 1) * rows] = np.mean(per_sp, axis=0)
    np.testing.assert_allclose(np.asarray(out.linear), lin_full, atol=1e-5)
    # to_image_order inverts the strided slab layout exactly: image row
    # k*4 + dp_i comes from slab row dp_i*rows + k (a pure permutation)
    img_order = np.asarray(sh.to_image_order(out.linear, 4, H))
    lin_np = np.asarray(out.linear)
    np.testing.assert_array_equal(img_order[5], lin_np[1 * rows + 1])
    np.testing.assert_array_equal(img_order[14], lin_np[2 * rows + 3])


@pytest.mark.slow
def test_shard_train_step_grads_match_emulation(scene_setup):
    pkt, cam, cfg0 = scene_setup
    cfg = RenderConfig(width=W, height=H, clamp_samples=False)
    mesh = sh.make_mesh((4, 2))
    params = sh.differentiable_params(pkt, cam)
    target = jnp.zeros((H, W, 3), jnp.float32)
    key = rng.key_for(3)
    loss, grads, _ = sh.shard_train_step(
        mesh, params, pkt, cam, target, key, cfg, spp=2
    )
    assert np.isfinite(float(loss))

    # single-device replay of the same sharded computation
    rows = H // 4
    local_spp = 2 // 2

    def emu_loss(params):
        # strided row assignment: chip dp_i renders image rows dp_i, dp_i+4…
        pkt2, cam2 = sh._apply_params(params, pkt, cam)
        total = 0.0
        for dp_i in range(4):
            imgs = []
            for sp_i in range(2):
                lkey = rng.fold(key, dp_i * 131071 + sp_i)
                acc = jnp.zeros((rows, W, 3))
                for s in range(local_spp):
                    acc = acc + sh._sample_rows(
                        rng.fold(lkey, s), pkt2, cam2, cfg, float(dp_i), rows, 4
                    ).reshape(rows, W, 3)
                imgs.append(acc / local_spp)
            img = (imgs[0] + imgs[1]) / 2.0
            t = target[dp_i * rows : (dp_i + 1) * rows]
            total = total + jnp.mean((img - t) ** 2)
        return total / 4.0

    eloss, egrads = jax.value_and_grad(emu_loss)(params)
    np.testing.assert_allclose(float(loss), float(eloss), rtol=1e-5)
    for k in grads:
        np.testing.assert_allclose(
            np.asarray(grads[k]), np.asarray(egrads[k]), rtol=1e-3, atol=1e-5,
            err_msg=k,
        )
    # something is learnable
    assert any(float(jnp.abs(grads[k]).max()) > 1e-6 for k in grads)


def test_strided_odd_height_render_and_train(scene_setup):
    """Odd heights (H % dp != 0) work under the strided default: render
    rows pad to dp*ceil(H/dp) and the train loss masks pad rows, so the
    loss equals the exact image MSE over the true H rows."""
    pkt, _, _ = scene_setup
    Ho = 13
    dp = 4
    cam = cam_ops.Camera.create(width=W, height=Ho)
    cfg = RenderConfig(width=W, height=Ho, clamp_samples=False)
    mesh = sh.make_mesh((dp, 2))
    hp = sh.padded_height(Ho, dp)
    assert hp == 16

    accum = pt.AccumState.create(hp, W)
    out = sh.shard_render_step(mesh, pkt, cam, accum, rng.key_for(5), cfg,
                               spp=2)
    img = np.asarray(sh.to_image_order(out.linear, dp, Ho))
    assert img.shape == (Ho, W, 3)
    assert np.isfinite(img).all() and img.max() > 0.05

    params = sh.differentiable_params(pkt, cam)
    key = rng.key_for(6)
    tgt_img = jnp.linspace(0, 1, Ho * W * 3).reshape(Ho, W, 3).astype(
        jnp.float32)
    loss, grads, _ = sh.shard_train_step(
        mesh, params, pkt, cam, sh.to_shard_order(tgt_img, dp), key, cfg,
        spp=2)
    assert np.isfinite(float(loss))
    for k, g in grads.items():
        assert np.isfinite(np.asarray(g)).all(), k

    # exact emulation: per-chip strided rows, pad rows masked, global MSE
    rows = hp // dp
    sse = 0.0
    for dp_i in range(dp):
        imgs = []
        for sp_i in range(2):
            lkey = rng.fold(key, dp_i * 131071 + sp_i)
            imgs.append(np.asarray(sh._sample_rows(
                rng.fold(lkey, 0), pkt, cam, cfg, float(dp_i), rows, dp
            )).reshape(rows, W, 3))
        img_c = (imgs[0] + imgs[1]) / 2.0
        ys = dp_i + dp * np.arange(rows)
        t = np.asarray(tgt_img)[np.minimum(ys, Ho - 1)]
        mask = (ys < Ho).astype(np.float32)[:, None, None]
        sse += float(np.sum(mask * (img_c - t) ** 2))
    np.testing.assert_allclose(float(loss), sse / (Ho * W * 3), rtol=1e-5)


@pytest.mark.slow  # convergence property, ~1 min: nightly tier
def test_train_step_reduces_loss(scene_setup):
    pkt, cam, _ = scene_setup
    cfg = RenderConfig(width=W, height=H, clamp_samples=False)
    mesh = sh.make_mesh((8, 1))
    params = sh.differentiable_params(pkt, cam)
    # target: render with brighter materials, then recover by descent
    target_params = dict(params)
    target_params["mat_albedo"] = params["mat_albedo"] * 0.5
    tp, tc = sh._apply_params(target_params, pkt, cam)
    taccum = sh.shard_render_step(
        mesh, tp, tc, pt.AccumState.create(H, W), rng.key_for(11), cfg, spp=2
    )
    target = taccum.linear

    # fixed key → deterministic objective; small lr so SGD descends
    losses = []
    key = rng.key_for(12)
    for _ in range(4):
        loss, grads, params = sh.shard_train_step(
            mesh, params, pkt, cam, target, key, cfg, spp=2, lr=0.02
        )
        losses.append(float(loss))
    assert losses[-1] < losses[0]


@pytest.mark.slow  # factory-wiring redundancy of the direct-call tests above
def test_make_step_factories_match_direct(scene_setup):
    """The jitted factory steps equal the direct (unjitted) calls."""
    pkt, cam, cfg = scene_setup
    mesh = sh.make_mesh((4, 2))

    rstep = sh.make_render_step(mesh, cam, cfg, spp=2)
    direct = sh.shard_render_step(
        mesh, pkt, cam, pt.AccumState.create(H, W), rng.key_for(3), cfg, spp=2
    )
    jitted = rstep(pkt, pt.AccumState.create(H, W), rng.key_for(3))
    np.testing.assert_allclose(
        np.asarray(jitted.linear), np.asarray(direct.linear), atol=1e-6
    )
    assert int(jitted.frame) == int(direct.frame) == 2
    # second call exercises the jit cache (no per-call shard_map rebuild)
    again = rstep(pkt, jitted, rng.key_for(4))
    assert int(again.frame) == 4

    params = sh.differentiable_params(pkt, cam)
    target = jnp.zeros((H, W, 3), jnp.float32)
    tstep = sh.make_train_step(mesh, cam, cfg, spp=2, lr=0.01)
    l1, g1, p1 = sh.shard_train_step(
        mesh, params, pkt, cam, target, rng.key_for(5), cfg, spp=2, lr=0.01
    )
    l2, g2, p2 = tstep(params, pkt, target, rng.key_for(5))
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-6)
    for k in g1:
        np.testing.assert_allclose(
            np.asarray(g1[k]), np.asarray(g2[k]), rtol=1e-5, atol=1e-7
        )
