"""Command-line interface: render frame sequences to files.

Replaces the reference's interactive Win32 shell (`main.cu`, `window.cu`,
keyboard/mouse): the `P`-key engine toggle becomes `--engine/--toggle-every`,
the right-mouse accumulation reset becomes `--reset-every`, the FPS title bar
becomes a printed metrics summary, and the swap chain becomes PNG/PPM frame
sequences (the reference README's own planned feature).

Usage:
  python -m ptre.cli render --scene demo --width 640 --height 360 \
      --frames 8 --spp 4 --out /tmp/frames
  python -m ptre.cli render --engine raster --out /tmp/frames
  python -m ptre.cli bench --width 1920 --height 1080
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ptre.models import demo
from ptre.ops import camera as cam_ops
from ptre.render.engine import EngineKind, Renderer
from ptre.utils import checkpoint as ckpt
from ptre.utils.config import RasterConfig, RenderConfig
from ptre.utils.image import write_image
from ptre.utils.metrics import configure_logging, logger

SCENES = {
    "demo": demo.reference_demo_scene,
    "sphere-light": demo.sphere_light_scene,
    "cornell": demo.cornell_spheres_scene,
}


def _build_renderer(args) -> Renderer:
    scene = SCENES[args.scene]()
    cam = cam_ops.Camera.create(
        width=args.width,
        height=args.height,
        projection=cam_ops.ORTHOGRAPHIC if args.orthographic else cam_ops.PERSPECTIVE,
    )
    cfg = RenderConfig(
        width=args.width, height=args.height, max_depth=args.max_depth,
        seed=args.seed,
    )
    engine = EngineKind.RASTERIZER if args.engine == "raster" else EngineKind.PATHTRACER
    return Renderer(
        scene, cam, cfg,
        RasterConfig(width=args.width, height=args.height),
        engine=engine, spp_per_frame=args.spp, ray_chunk=args.ray_chunk,
    )


def cmd_render(args) -> int:
    r = _build_renderer(args)
    if args.resume and os.path.exists(args.resume):
        accum, seed, frame_index, _ = ckpt.load_render_state(args.resume)
        r.accum, r._frame_index = accum, frame_index
        logger.info("resumed from %s at %d samples", args.resume, int(accum.frame))

    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    for i in range(args.frames):
        if args.toggle_every and i and i % args.toggle_every == 0:
            r.toggle_engine()
        if args.reset_every and i and i % args.reset_every == 0:
            r.reset()
        img = r.draw_frame()
        write_image(os.path.join(args.out, f"frame_{i:05d}.{args.format}"), img)
        if args.checkpoint:
            ckpt.save_render_state(args.checkpoint, r.accum, args.seed, r._frame_index)
    logger.info(
        "%d frames in %.2fs | %s", args.frames, time.perf_counter() - t0,
        r.metrics.summary(),
    )
    return 0


def cmd_bench(args) -> int:
    # delegate to the repo-level benchmark for a single comparable line,
    # forwarding the requested size (cli --width/--height are honored)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import bench

    bench.main(["--width", str(args.width), "--height", str(args.height)])
    return 0


def cmd_info(args) -> int:
    import jax

    print(json.dumps({
        "backend": jax.default_backend(),
        "devices": [str(d) for d in jax.devices()],
        "scenes": sorted(SCENES),
    }, indent=2))
    return 0


def main(argv=None) -> int:
    configure_logging()
    p = argparse.ArgumentParser(prog="ptre", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a frame sequence")
    pr.add_argument("--scene", choices=sorted(SCENES), default="demo")
    pr.add_argument("--engine", choices=["pt", "raster"], default="pt")
    pr.add_argument("--width", type=int, default=1280)
    pr.add_argument("--height", type=int, default=720)
    pr.add_argument("--frames", type=int, default=1)
    pr.add_argument("--spp", type=int, default=1, help="samples per frame")
    pr.add_argument("--max-depth", type=int, default=5)
    pr.add_argument("--seed", type=int, default=1984)
    pr.add_argument("--ray-chunk", type=int, default=0)
    pr.add_argument("--orthographic", action="store_true")
    pr.add_argument("--toggle-every", type=int, default=0,
                    help="toggle engine every N frames (the 'P' key)")
    pr.add_argument("--reset-every", type=int, default=0,
                    help="reset accumulation every N frames (right mouse)")
    pr.add_argument("--out", default="frames")
    pr.add_argument("--format", choices=["png", "ppm", "npy"], default="png")
    pr.add_argument("--checkpoint", default=None, help="save state here each frame")
    pr.add_argument("--resume", default=None, help="load state from checkpoint")
    pr.set_defaults(fn=cmd_render)

    pb = sub.add_parser("bench", help="run the standard benchmark")
    pb.add_argument("--width", type=int, default=1920)
    pb.add_argument("--height", type=int, default=1080)
    pb.set_defaults(fn=cmd_bench)

    pi = sub.add_parser("info", help="print backend/devices/scenes")
    pi.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
