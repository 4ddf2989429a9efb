"""Benchmark: path-tracing throughput on one GPU.

Prints the device (platform, device kind, count, and the card's name and
power limit from ``nvidia-smi``) on one line, then ONE JSON line:
{"metric", "value", "unit", "vs_baseline", "device", "extra"}. Exits nonzero
without a GPU: it has no CPU fallback.

Primary metric: forward Mrays/s of the progressive path tracer
(`pathtracer.render_step_jit`, which takes the Triton path kernel on a GPU)
on the reference demo scene at the given size (default 1080p). A "ray" is
one traced bounce segment: max_depth (5) segments per sample path, matching
the reference's per-thread bounce loop (`path_tracer.cu:252`).

"extra" carries forward+backward Mrays/s of the differentiable train step
(`train.mse_step`, staged XLA route) with gradients w.r.t. every leaf of
`differentiable_params` (transforms, spheres, materials, sky, camera) at
spp=1, and of one 64-spp step (`two_pass_mse_step` for the mixed scene).

vs_baseline: the reference publishes no numbers (BASELINE.md). Its duty
cycle implies an upper bound of 1280*720*1spp per 0.1 s kernel cadence x 5
bounces = 46.08 Mrays/s on its CC 7.5 GPU (`path_tracer.cu:378,402`,
`window.h:40-41`); the forward throughput is reported relative to that
derived figure. The reference has no backward at all.

Flags: --width/--height (also reachable via `ptre.cli bench`), --skip-bwd /
--skip-fwd to time one pipeline only, --tri-scene for BASELINE config 3
(16k triangles, 512^2), --mixed-scene for config 4.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _scene(kind):
    """Benchmark scenes: "demo" (reference demo), "tri" (BASELINE config 3:
    uv_sphere(128, 64) forced TRIANGLES, ~16k tris — the reference's known
    scaling cliff, `path_tracer.cu:263-282`), "mixed" (BASELINE config 4:
    mixed analytic + ~16k-tri mesh scene with deep diffuse paths)."""
    from ptre.models import demo

    if kind == "tri":
        return demo.config3_scene(segments=128, rings=64)
    if kind == "mixed":
        return demo.config4_mixed_scene(segments=128, rings=64)
    return demo.reference_demo_scene(32, 16)


def _bench_forward(W, H, spp, steps, scene="demo"):
    import jax

    from ptre.ops import camera as cam_ops, rng
    from ptre.render import pathtracer as pt
    from ptre.utils.config import RenderConfig

    pkt = _scene(scene).build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    accum = pt.AccumState.create(H, W)
    key = rng.key_for(cfg.seed)

    # no ray_chunk: it only bounds the staged route's (rays x primitives)
    # intermediate, and on the GPU the forward takes the path kernel, whose
    # whole 1080p step measured 99.5 MB of temporaries on an H100 (PERF.md)
    accum = pt.render_step_jit(pkt, cam, accum, rng.fold(key, 0), cfg,
                               spp=spp)
    jax.block_until_ready(accum)

    t0 = time.perf_counter()
    for i in range(1, steps + 1):
        accum = pt.render_step_jit(pkt, cam, accum, rng.fold(key, i), cfg,
                                   spp=spp)
    jax.block_until_ready(accum)
    dt = time.perf_counter() - t0

    rays = W * H * spp * steps * cfg.max_depth
    return rays / dt / 1e6


def _bench_fwdbwd(W, H, steps, scene="demo"):
    """Forward+backward Mrays/s of the image-MSE train step at spp=1 and of
    one 64-spp step. Asserts every gradient leaf is finite."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ptre.ops import camera as cam_ops, rng
    from ptre.parallel import sharding as sh
    from ptre.render import train
    from ptre.utils.config import RenderConfig

    pkt = _scene(scene).build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    key = rng.key_for(cfg.seed)
    params = sh.differentiable_params(pkt, cam)
    target = jnp.zeros((W * H, 3), jnp.float32)

    def check(grads, what):
        for k, v in grads.items():
            assert np.isfinite(np.asarray(v)).all(), (
                f"non-finite gradient leaf {k!r} at {W}x{H} {what}")

    step64 = (train.two_pass_mse_step if scene == "mixed"
              else train.mse_step)
    _, grads = step64(params, pkt, cam, target, key, cfg, spp=64)
    check(grads, "64spp")
    t0 = time.perf_counter()
    _, grads = step64(params, pkt, cam, target, rng.fold(key, 0x64), cfg,
                      spp=64)
    jax.block_until_ready(grads)
    t64 = time.perf_counter() - t0

    _, grads = train.mse_step(params, pkt, cam, target, rng.fold(key, 1), cfg)
    check(grads, "spp=1")
    t0 = time.perf_counter()
    for i in range(2, steps + 2):
        _, grads = train.mse_step(params, pkt, cam, target,
                                  rng.fold(key, i), cfg)
    jax.block_until_ready(grads)
    dt = (time.perf_counter() - t0) / steps

    rays_per_sample = W * H * cfg.max_depth
    return rays_per_sample / dt / 1e6, rays_per_sample * 64 / t64 / 1e6


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=None,
                   help="image width (default 1920, or 512 with --tri-scene)")
    p.add_argument("--height", type=int, default=None,
                   help="image height (default 1080, or 512 with --tri-scene)")
    p.add_argument("--spp", type=int, default=4, help="spp per forward step")
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--skip-bwd", action="store_true")
    p.add_argument("--skip-fwd", action="store_true")
    p.add_argument("--tri-scene", action="store_true",
                   help="bench BASELINE config 3 (~16k-tri scene at 512^2)")
    p.add_argument("--mixed-scene", action="store_true",
                   help="bench BASELINE config 4: the mixed analytic+mesh "
                        "~16k-tri scene at 1080p, 64-spp step two-pass")
    args = p.parse_args(argv)

    from ptre.utils import device

    device.require_gpu()
    device.enable_compile_cache()
    info = device.device_info()
    print(json.dumps({"device": info, "card": device.card_line()}))

    dw, dh = (512, 512) if args.tri_scene else (1920, 1080)
    W = args.width if args.width is not None else dw
    H = args.height if args.height is not None else dh
    scene = ("tri" if args.tri_scene
             else "mixed" if args.mixed_scene else "demo")
    extra = {}
    fwd = None
    if not args.skip_fwd:
        fwd = _bench_forward(W, H, args.spp, args.steps, scene=scene)
    if not args.skip_bwd:
        fb, fb64 = _bench_fwdbwd(W, H, args.steps, scene=scene)
        extra["fwdbwd_mrays_per_s"] = fb
        extra["fwdbwd_64spp_step_mrays_per_s"] = fb64
    if fwd is None:
        fwd = extra.get("fwdbwd_mrays_per_s", 0.0)

    baseline_mrays = 1280 * 720 * 10 * 5 / 1e6  # 46.08 (module docstring)
    tag = {"tri": "_tri16k", "mixed": "_mixed16k"}.get(scene, "")
    print(json.dumps({
        "metric": f"pathtrace_{H}p{tag}_mrays_per_s",
        "value": fwd,
        "unit": "Mrays/s",
        "vs_baseline": fwd / baseline_mrays,
        "device": info,
        "extra": extra,
    }))


if __name__ == "__main__":
    main()
