"""Regenerate golden images for tests/goldens/ (run on CPU).

Goldens are deterministic CPU-jit renders at fixed keys covering the
BASELINE.json configs at test scale. Regenerate ONLY when an intentional
behavior change lands: `python scripts/make_goldens.py`.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from ptre.models import demo
from ptre.ops import camera as cam_ops, rng
from ptre.render import pathtracer as pt
from ptre.render import rasterizer as ras
from ptre.utils.config import RasterConfig, RenderConfig
from ptre.utils.image import write_ppm

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "goldens")


def render_pt(scene, cam_kw, cfg_kw, spp, seed):
    w, h = cfg_kw["width"], cfg_kw["height"]
    cam = cam_ops.Camera.create(width=w, height=h, **cam_kw)
    cfg = RenderConfig(**cfg_kw)
    accum = pt.AccumState.create(h, w)
    pkt = scene.build_packet()
    accum = pt.render_step(pkt, cam, accum, rng.key_for(seed), cfg, spp=spp)
    return np.asarray(pt.to_display(accum.linear))


def render_raster(scene, cam_kw, w, h):
    cam = cam_ops.Camera.create(width=w, height=h, **cam_kw)
    cfg = RasterConfig(width=w, height=h, supersample=2)
    pkt = scene.build_packet(spheres_as_triangles=True)
    img = np.asarray(ras.rasterize(pkt, cam, cfg))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


GOLDENS = {
    # BASELINE config 1: analytic sphere + emissive quad light, 2 bounces
    "config1_sphere_light.ppm": lambda: render_pt(
        demo.sphere_light_scene(),
        dict(position=(0.0, 1.0, -4.0), forward=(0.0, -0.2, 4.0)),
        dict(width=64, height=64, max_depth=2), spp=4, seed=11,
    ),
    # BASELINE config 2 (test scale): Cornell-style spheres, 4 bounces
    "config2_cornell.ppm": lambda: render_pt(
        demo.cornell_spheres_scene(),
        dict(position=(0.0, 1.5, -6.0), forward=(0.0, -0.2, 6.0)),
        dict(width=64, height=64, max_depth=4), spp=4, seed=22,
    ),
    # reference demo scene, default camera
    "demo_pt.ppm": lambda: render_pt(
        demo.reference_demo_scene(16, 8), {},
        dict(width=64, height=36, max_depth=5), spp=4, seed=1984,
    ),
    # orthographic camera variant (matrix.cu:325-341 path)
    "demo_ortho.ppm": lambda: render_pt(
        demo.reference_demo_scene(16, 8),
        dict(projection=cam_ops.ORTHOGRAPHIC),
        dict(width=64, height=36, max_depth=3), spp=2, seed=7,
    ),
    # rasterizer pass over the demo scene
    "demo_raster.ppm": lambda: render_raster(
        demo.reference_demo_scene(16, 8), {}, 64, 36,
    ),
    # BASELINE config 3 (test scale): triangle-forced uv-sphere, smooth
    # normals (the reference scaling-cliff scene)
    "config3_trimesh_smooth.ppm": lambda: render_pt(
        demo.config3_scene(flat=False, segments=24, rings=12, diffuse=True), {},
        dict(width=64, height=64, max_depth=5), spp=4, seed=33,
    ),
    # config 3, FLAT-shaded variant (per-face normals; mesh.cu:198 TODO)
    "config3_trimesh_flat.ppm": lambda: render_pt(
        demo.config3_scene(flat=True, segments=24, rings=12, diffuse=True), {},
        dict(width=64, height=64, max_depth=5), spp=4, seed=33,
    ),
    # BASELINE config 4 (test scale): mixed analytic + mesh scene,
    # perspective and orthographic cameras
    "config4_mixed_persp.ppm": lambda: render_pt(
        demo.config4_mixed_scene(segments=24, rings=12), {},
        dict(width=64, height=64, max_depth=5), spp=4, seed=44,
    ),
    "config4_mixed_ortho.ppm": lambda: render_pt(
        demo.config4_mixed_scene(segments=24, rings=12),
        dict(projection=cam_ops.ORTHOGRAPHIC),
        dict(width=64, height=64, max_depth=5), spp=4, seed=44,
    ),
}


def main():
    os.makedirs(OUT, exist_ok=True)
    for name, fn in GOLDENS.items():
        img = fn()
        write_ppm(os.path.join(OUT, name), img)
        print(f"wrote {name} {img.shape} mean={img.mean():.1f}")


if __name__ == "__main__":
    main()
