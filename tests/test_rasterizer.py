"""Rasterizer tests: HLSL shading math, culling, z-buffer, A/B vs path tracer."""

import jax
import jax.numpy as jnp
import numpy as np

from ptre.models import demo, mesh as mg
from ptre.models.scene import Model, Scene
from ptre.ops import camera as cam_ops
from ptre.render import rasterizer as ras
from ptre.utils.config import RasterConfig, RenderConfig

CLEAR = np.array([0.62, 0.84, 1.0], np.float32)


def _cam(w=64, h=64, **kw):
    kw.setdefault("position", (0.0, 0.0, -3.0))
    kw.setdefault("forward", (0.0, 0.0, 1.0))
    return cam_ops.Camera.create(width=w, height=h, **kw)


def _cfg(w=64, h=64, **kw):
    return RasterConfig(width=w, height=h, **kw)


def _single_tri_scene(flip=False):
    """One big triangle in front of the camera; CW front-facing by default."""
    scn = Scene()
    m = mg.tri()
    if flip:
        m = mg.Mesh(m.positions, m.normals, m.indices[::-1].copy(), m.mesh_type)
    scn.add_mesh("t", m)
    scn.add_model("m", Model("t"))
    scn.get_model("m").set_transforms(4.0, 0.0, (0.0, 0.0, 0.0))
    return scn


def test_clear_color_on_empty():
    scn = Scene()
    scn.add_mesh("t", mg.tri())
    pkt = scn.build_packet(spheres_as_triangles=True)
    img = ras.rasterize(pkt, _cam(), _cfg())
    np.testing.assert_allclose(np.asarray(img), np.broadcast_to(CLEAR, (64, 64, 3)), atol=1e-6)


def test_front_facing_triangle_shaded_like_hlsl():
    scn = _single_tri_scene()
    pkt = scn.build_packet(spheres_as_triangles=True)
    img = np.asarray(ras.rasterize(pkt, _cam(), _cfg()))
    center = img[32, 32]
    # pixel_shader.hlsl: ambient 0.2*clear + diffuse max(dot(-n, (0,-1,0)), 0)
    # n = (0,0,-1) → diffuse = 0 → color = 0.2*clear * albedo(red)
    expect = 0.2 * CLEAR * np.array([1.0, 0.0, 0.0])
    np.testing.assert_allclose(center, expect, atol=1e-5)
    # background pixels stay clear
    np.testing.assert_allclose(img[2, 2], CLEAR, atol=1e-6)


def test_backface_culled():
    scn = _single_tri_scene(flip=True)
    pkt = scn.build_packet(spheres_as_triangles=True)
    img = np.asarray(ras.rasterize(pkt, _cam(), _cfg()))
    np.testing.assert_allclose(img[32, 32], CLEAR, atol=1e-6)
    # with culling disabled it renders
    img2 = np.asarray(ras.rasterize(pkt, _cam(), _cfg(cull_backfaces=False)))
    assert not np.allclose(img2[32, 32], CLEAR)


def test_diffuse_top_lit():
    # cube viewed from above-front: top face has n = (0,1,0) → diffuse = 1
    scn = Scene()
    scn.add_mesh("cube", mg.cube())
    scn.add_model("c", Model("cube"))
    pkt = scn.build_packet(spheres_as_triangles=True)
    cam = _cam(position=(0.0, 4.0, -2.0), forward=(0.0, -4.0, 2.0))
    img = np.asarray(ras.rasterize(pkt, cam, _cfg()))
    expect_top = (0.2 * CLEAR + 1.0) * np.array([1.0, 0.0, 0.0])
    expect_top = np.clip(expect_top, 0, None)
    center = img[32, 32]
    np.testing.assert_allclose(center, expect_top, atol=1e-4)


def test_zbuffer_depth_ordering():
    # near triangle occludes far triangle
    scn = Scene()
    scn.add_mesh("t", mg.tri())
    scn.add_model("near", Model("t"))
    scn.get_model("near").set_transforms(2.0, 0.0, (0.0, 0.0, 0.0))
    scn.add_model("far", Model("t"))
    # far one: huge and tilted so its normal differs → different shade
    scn.get_model("far").set_transforms(8.0, (0.5, 0.0, 0.0), (0.0, 0.0, 3.0))
    pkt = scn.build_packet(spheres_as_triangles=True)
    img = np.asarray(ras.rasterize(pkt, _cam(), _cfg()))
    # center shows the near triangle's shade (n = (0,0,-1) → diffuse 0 →
    # ambient red), not the tilted far triangle's brighter shade
    expect_near = 0.2 * CLEAR * np.array([1.0, 0.0, 0.0])
    np.testing.assert_allclose(img[32, 32], expect_near, atol=1e-5)
    # the far triangle is visible around the near one and shades brighter
    assert img[4, 32, 0] > expect_near[0] + 0.05


def test_supersample_antialiases():
    scn = _single_tri_scene()
    pkt = scn.build_packet(spheres_as_triangles=True)
    img1 = np.asarray(ras.rasterize(pkt, _cam(), _cfg(supersample=1)))
    img4 = np.asarray(ras.rasterize(pkt, _cam(), _cfg(supersample=2)))
    # supersampled edges produce intermediate values absent at 1x
    uniq4 = np.unique(np.round(img4[:, :, 0], 3)).size
    uniq1 = np.unique(np.round(img1[:, :, 0], 3)).size
    assert uniq4 > uniq1


def test_row_chunking_matches():
    scn = demo.reference_demo_scene(12, 6)
    pkt = scn.build_packet(spheres_as_triangles=True)
    cam = cam_ops.Camera.create(width=32, height=32)
    cfg = _cfg(32, 32)
    a = np.asarray(ras.rasterize(pkt, cam, cfg))
    b = np.asarray(ras.rasterize(pkt, cam, cfg, row_chunk=16))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_ab_silhouette_matches_path_tracer():
    """The reference's defining property: both engines share one camera and
    show the same geometry (`camera.cu:20-43` inverse pipeline)."""
    from ptre.ops import integrator, rng
    from ptre.render import pathtracer as pt

    scn = demo.reference_demo_scene(48, 24)
    cam = cam_ops.Camera.create(width=48, height=32)

    # PT primary-hit mask (analytic spheres + cube)
    pkt = scn.build_packet()
    from ptre.ops.intersect import closest_hit

    px, py = pt.pixel_grid(32, 48)
    o, d = cam_ops.get_rays(cam, px, py, jnp.zeros((32 * 48, 2)))
    hr = closest_hit(o, d, pkt, pkt.world_triangles(), 1e-6, 999.99)
    pt_mask = np.asarray(hr.hit).reshape(32, 48)

    # raster coverage mask (same scene, spheres as real uv meshes)
    rpkt = scn.build_packet(spheres_as_triangles=True)
    img = np.asarray(ras.rasterize(rpkt, cam, _cfg(48, 32, supersample=1)))
    ras_mask = ~np.all(np.abs(img - CLEAR) < 1e-5, axis=-1)

    agreement = (pt_mask == ras_mask).mean()
    assert agreement > 0.93, agreement


def test_soft_rasterizer_differentiable_silhouette():
    scn = _single_tri_scene()
    pkt = scn.build_packet(spheres_as_triangles=True)
    cam = _cam(32, 32)
    cfg = _cfg(32, 32, supersample=1)

    def loss(dx):
        tf = pkt.transforms.at[0, 3, 0].add(dx)
        p = pkt.replace(transforms=tf)
        img = ras.rasterize(p, cam, cfg, soft=True, sigma=0.5)
        return jnp.mean(img[:, :, 0])  # red channel mean moves with coverage

    g = jax.grad(loss)(jnp.float32(0.0))
    assert np.isfinite(float(g))
    eps = 1e-2
    fd = (loss(jnp.float32(eps)) - loss(jnp.float32(-eps))) / (2 * eps)
    np.testing.assert_allclose(float(g), float(fd), rtol=0.2, atol=1e-4)


def test_rasterize_frames_matches_per_frame():
    """K-frames-per-dispatch (`rasterize_frames`) == K single rasterize
    calls frame-for-frame — batching frames must not change images."""
    from ptre.ops import vecmat as vm

    scn = demo.reference_demo_scene(8, 4)
    pkt = scn.build_packet(spheres_as_triangles=True)
    cam = _cam(32, 32, position=(0.0, 2.0, -9.0))
    cfg = _cfg(32, 32)

    frames = []
    for f in range(3):
        tf = pkt.transforms
        rot = vm.rotation_y(jnp.float32(0.1 * f))
        frames.append(tf.at[-1].set(rot @ tf[-1]))
    seq = jnp.stack(frames)

    batched = ras.rasterize_frames(pkt, cam, seq, cfg)
    for f in range(3):
        one = ras.rasterize(pkt.replace(transforms=seq[f]), cam, cfg,
                            )
        np.testing.assert_allclose(np.asarray(batched[f]), np.asarray(one),
                                   rtol=1e-6, atol=1e-6)


def _all_pairs_hard_tile(sx, sy, screen, depth01, w, normals, valid, config,
                         soft, sigma):
    """The hard z-buffer as first written: shade EVERY (sample, triangle)
    pair, then gather the z-test winner's color."""
    x0, y0 = screen[:, 0, 0], screen[:, 0, 1]
    x1, y1 = screen[:, 1, 0], screen[:, 1, 1]
    x2, y2 = screen[:, 2, 0], screen[:, 2, 1]
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    keep = valid & (jnp.min(w, axis=1) > 0.0)
    keep = keep & (area > 0.0) if config.cull_backfaces else (
        keep & (jnp.abs(area) > 0.0))

    def san(v, fill=0.0):
        return jnp.where(keep, v, fill)

    x0, y0, x1, y1, x2, y2 = map(san, (x0, y0, x1, y1, x2, y2))
    depth01 = jnp.where(keep[:, None], depth01, 0.5)
    w = jnp.where(keep[:, None], w, 1.0)
    normals = jnp.where(keep[:, None, None], normals, 0.0)
    inv_area = 1.0 / jnp.where(san(area, 1.0) == 0.0, 1.0, san(area, 1.0))
    px, py = sx[:, None], sy[:, None]
    w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area[None, :]
    w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area[None, :]
    w2 = 1.0 - w0 - w1
    z = (w0 * depth01[None, :, 0] + w1 * depth01[None, :, 1]
         + w2 * depth01[None, :, 2])
    iw = 1.0 / w
    denom = w0 * iw[None, :, 0] + w1 * iw[None, :, 1] + w2 * iw[None, :, 2]
    n = (w0[..., None] * (normals[:, 0] * iw[:, 0, None])[None]
         + w1[..., None] * (normals[:, 1] * iw[:, 1, None])[None]
         + w2[..., None] * (normals[:, 2] * iw[:, 2, None])[None]
         ) / denom[..., None]
    color = ras.shade(ras.vm.normalize(n), config)  # (P, T, 3)
    covered = ((w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
               & (z >= 0.0) & (z <= 1.0) & keep[None, :])
    best = jnp.argmin(jnp.where(covered, z, jnp.inf), axis=1)
    out = jnp.take_along_axis(color, best[:, None, None], axis=1)[:, 0, :]
    return jnp.where(jnp.any(covered, axis=1)[:, None], out,
                     jnp.asarray(config.clear_color, jnp.float32))


def test_deferred_winner_matches_all_pairs_shading(monkeypatch):
    """Shading only the z-test winner gives the image that shading every
    (sample, triangle) pair and gathering the winner gave."""
    pkt = demo.reference_demo_scene(16, 8).build_packet(
        spheres_as_triangles=True)
    cam = cam_ops.Camera.create(width=48, height=32)
    cfg = RasterConfig(width=48, height=32)
    new = np.asarray(ras.rasterize(pkt, cam, cfg))
    monkeypatch.setattr(ras, "_raster_tile", _all_pairs_hard_tile)
    old = np.asarray(ras.rasterize(pkt, cam, cfg))
    assert (np.abs(old - CLEAR).max(-1) > 1e-3).mean() > 0.2  # geometry
    np.testing.assert_allclose(new, old, atol=1e-6)


def test_interpolated_normal_finite_where_perspective_denominator_is_zero():
    """A far (sample, triangle) pair of the soft blend can have a zero
    perspective denominator; its shaded value and gradient stay finite."""
    cfg = RasterConfig()
    iw = jnp.array([[1.0, 1.0, 1.0]], jnp.float32)
    normals = jnp.eye(3, dtype=jnp.float32)[None]

    def f(w0):
        w1, w2 = -w0, jnp.zeros_like(w0)  # denom = w0 - w0 = 0
        return jnp.sum(ras._shade_interp(w0, w1, w2, iw, normals, cfg))

    w0 = jnp.array([0.5], jnp.float32)
    assert np.isfinite(float(f(w0)))
    assert np.isfinite(np.asarray(jax.grad(f)(w0))).all()
