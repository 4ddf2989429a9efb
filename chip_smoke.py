"""Smoke run of both engines on one GPU, through the normal entry points.

    python chip_smoke.py            # one card: phases 1-7 below
    python chip_smoke.py --multi    # four cards: the sharded path only

Phases (one card), each printing one JSON line with its times (compile and
steady state, seconds), memory (``peak_bytes_in_use`` so far, and the
compiled step's temporary bytes) and parity figures:

  1. device   — require a GPU, print the card's name and power limit
                 (``nvidia-smi``), set up the persistent compile cache;
  2. fwd_demo — demo scene at 1920x1080 through `render_step_jit` (the
                 Triton path kernel), checked against the staged XLA route
                 on the same key;
  3. fwd_tri  — BASELINE config 3 (16,128 triangles) at 512x512, the same;
  4. train    — `train.mse_step` on the demo at 1080p, spp=1 and spp=64,
                 every gradient leaf finite;
  5. xdev     — render, spp=1 gradients and the hard raster at small size
                 on the GPU against the CPU device of this process;
  6. raster   — hard raster at 1280x720 ss=2; soft raster forward and
                 backward at the same size, gradients finite;
  7. tests    — the tests marked ``gpu`` (`pytest -m gpu`), in this process.

``--multi`` needs four GPUs and runs only: the demo at 1080p through
`shard_train_step` on a (4, 1) mesh against a one-card replay of the same
per-shard computation, `dual_pipeline_step` against the one-card raster and
render, and a check that each shard lives on its own card.

Every phase runs in this one process (one JAX process per card). A failed
phase is reported and the script exits nonzero; the last line is
``{"ok": true, "device": {...}}`` only when every phase passed. Without a
GPU it exits nonzero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

#: Triton forward vs staged XLA, same key and uniforms. A near-tie between
#: two primitives (or an edge-on triangle) can resolve differently under
#: another float summation order and send one path elsewhere, so the bar is
#: statistical: few pixels may differ visibly, and the mean must stay tiny.
FWD_MAX_FRAC_PX = 1e-3  # pixels with any channel off by more than 1e-3
FWD_DIFF = 1e-3
FWD_MAX_MEAN_ABS = 1e-5
#: GPU vs CPU gradients of the spp=1 image MSE: per-leaf relative L2.
#: Shading, material and sky leaves agree to ~1e-7; geometry and camera
#: leaves carry the heavy-tailed silhouette / grazing Jacobians
#: (`ops.gradsafe`), which amplify last-ulp differences between the two
#: devices' math to a few 1e-4 (measured up to 3.9e-4 on an H100)
GRAD_MAX_REL_L2 = 1e-3
#: GPU vs CPU hard raster: fraction of pixels that may differ (z-ties and
#: samples exactly on a shared edge, which another rounding can flip)
RASTER_MAX_FRAC_PX = 1e-3
#: four cards vs the one-card replay: loss and per-leaf gradient rel. L2
MULTI_MAX_REL = 1e-4

GPU_TEST_FILES = ["tests/test_path_kernel.py"]

#: shapes: the widths the repo supports (BASELINE configs)
DEMO_WH = (1920, 1080)
TRI_WH = (512, 512)
TRI_TESSELLATION = (128, 64)  # uv sphere segments, rings: 16,128 triangles
RASTER_WH = (1280, 720)
TRAIN_SPP = (1, 64)
SMALL_WH = (320, 180)  # cross-device render / raster
GRAD_WH = (64, 64)  # cross-device gradients


def emit(obj):
    print(json.dumps(obj), flush=True)


def timed(fn, *args, reps=3):
    """(compile seconds, best steady seconds, output, compiled executable)."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        best = min(best, time.perf_counter() - t0)
    return t_compile, best, out, compiled


def temp_bytes(compiled):
    ma = compiled.memory_analysis()
    return None if ma is None else int(ma.temp_size_in_bytes)


def image_diff(a, b, thresh=FWD_DIFF):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    px = d.reshape(-1, d.shape[-1]).max(axis=-1)
    return {"frac_px_gt": float(np.mean(px > thresh)),
            "mean_abs": float(d.mean()), "max_abs": float(d.max())}


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def nonfinite_leaves(grads):
    """Names of gradient leaves holding a non-finite entry, with counts."""
    return {k: int((~np.isfinite(np.asarray(v))).sum())
            for k, v in grads.items() if not np.isfinite(np.asarray(v)).all()}


def _setup(scene, W, H):
    from ptre.ops import camera as cam_ops, rng
    from ptre.utils.config import RenderConfig

    pkt = scene.build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    return pkt, cam, cfg, rng.key_for(cfg.seed)


# ---------------------------------------------------------------- phases


def phase_device():
    from ptre.utils import device

    device.require_gpu()
    cache = device.enable_compile_cache()
    card = device.card_line()
    print(card, flush=True)
    return {"card": card, "compile_cache": cache, **device.device_info()}


def _forward_parity(scene, W, H):
    from ptre.render import pathtracer as pt
    from ptre.utils import device

    pkt, cam, cfg, key = _setup(scene, W, H)
    assert pt.uses_path_kernel()

    def kernel(pkt, cam, key):
        return pt.render_step(pkt, cam, pt.AccumState.create(H, W), key,
                              cfg).linear

    def staged(pkt, cam, key):
        return pt.staged_render_step(pkt, cam, pt.AccumState.create(H, W),
                                     key, cfg).linear

    with jax.default_matmul_precision("highest"):
        tk_c, tk, img_k, ck = timed(kernel, pkt, cam, key)
        ts_c, ts, img_s, cs = timed(staged, pkt, cam, key)
    diff = image_diff(img_k, img_s)
    ok = (np.isfinite(np.asarray(img_k)).all()
          and diff["frac_px_gt"] <= FWD_MAX_FRAC_PX
          and diff["mean_abs"] <= FWD_MAX_MEAN_ABS)
    return {"ok": bool(ok), "shape": [H, W], "kernel_s": tk,
            "kernel_compile_s": tk_c, "staged_s": ts,
            "staged_compile_s": ts_c, "kernel_temp_bytes": temp_bytes(ck),
            "staged_temp_bytes": temp_bytes(cs),
            "peak_bytes": device.peak_bytes(), **diff}


def phase_fwd_demo():
    from ptre.models import demo

    return _forward_parity(demo.reference_demo_scene(32, 16), *DEMO_WH)


def phase_fwd_tri():
    from ptre.models import demo

    seg, rings = TRI_TESSELLATION
    return _forward_parity(demo.config3_scene(segments=seg, rings=rings),
                           *TRI_WH)


def phase_train():
    from ptre.models import demo
    from ptre.parallel import sharding as sh
    from ptre.render import train
    from ptre.utils import device

    W, H = DEMO_WH
    pkt, cam, cfg, key = _setup(demo.reference_demo_scene(32, 16), W, H)
    params = sh.differentiable_params(pkt, cam)
    target = jnp.zeros((W * H, 3), jnp.float32)
    out = {"shape": [H, W]}
    ok = True
    for spp in TRAIN_SPP:
        def step(params, key, spp=spp):
            return train.mse_step(params, pkt, cam, target, key, cfg, spp=spp)

        tc, ts, (loss, grads), comp = timed(step, params, key, reps=1)
        nonfinite = nonfinite_leaves(grads)
        ok &= not nonfinite and np.isfinite(float(loss))
        out[f"spp{spp}"] = {"step_s": ts, "compile_s": tc,
                            "temp_bytes": temp_bytes(comp),
                            "loss": float(loss),
                            "nonfinite_grad_leaves": nonfinite}
    out["peak_bytes"] = device.peak_bytes()
    out["ok"] = bool(ok)
    return out


def phase_xdev():
    from ptre.models import demo
    from ptre.parallel import sharding as sh
    from ptre.render import pathtracer as pt
    from ptre.render import rasterizer as rz
    from ptre.render import train
    from ptre.utils.config import RasterConfig

    cpu = jax.devices("cpu")[0]

    def run_all():
        scn = demo.reference_demo_scene(32, 16)
        W, H = SMALL_WH
        pkt, cam, cfg, key = _setup(scn, W, H)
        # a fresh jit per device, so the route is chosen for each
        img = jax.jit(lambda pkt, cam, key: pt.render_step(
            pkt, cam, pt.AccumState.create(H, W), key, cfg).linear)(
                pkt, cam, key)
        gW, gH = GRAD_WH
        gpkt, gcam, gcfg, gkey = _setup(scn, gW, gH)
        target = jnp.zeros((gW * gH, 3), jnp.float32)
        loss, grads = train.mse_step(sh.differentiable_params(gpkt, gcam),
                                     gpkt, gcam, target, gkey, gcfg)
        rpkt = scn.build_packet(spheres_as_triangles=True)
        ras = rz.rasterize_jit(rpkt, cam, RasterConfig(width=W, height=H))
        return jax.device_get((img, loss, grads, ras))

    with jax.default_matmul_precision("highest"):
        gpu = run_all()
        with jax.default_device(cpu):
            assert not pt.uses_path_kernel()
            ref = run_all()
    img = image_diff(gpu[0], ref[0])
    grad_rel = {k: rel_l2(gpu[2][k], ref[2][k]) for k in ref[2]}
    ras_px = np.abs(gpu[3] - ref[3]).max(axis=-1) > 1e-5
    ok = (img["frac_px_gt"] <= FWD_MAX_FRAC_PX
          and img["mean_abs"] <= FWD_MAX_MEAN_ABS
          and max(grad_rel.values()) <= GRAD_MAX_REL_L2
          and ras_px.mean() <= RASTER_MAX_FRAC_PX)
    return {"ok": bool(ok), "render_wh": SMALL_WH, "render": img,
            "grad_wh": GRAD_WH, "loss_rel": abs(float(gpu[1]) - float(ref[1]))
            / max(abs(float(ref[1])), 1e-30),
            "grad_rel_l2": grad_rel,
            "raster_px_differ": int(ras_px.sum()),
            "raster_px": int(ras_px.size)}


def phase_raster():
    from ptre.models import demo
    from ptre.ops import camera as cam_ops
    from ptre.render import rasterizer as rz
    from ptre.utils import device
    from ptre.utils.config import RasterConfig

    W, H = RASTER_WH
    scn = demo.reference_demo_scene(32, 16)
    rpkt = scn.build_packet(spheres_as_triangles=True)
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RasterConfig(width=W, height=H, supersample=2)

    def hard(rpkt, cam):
        return rz.rasterize(rpkt, cam, cfg)

    tc, ts, img, comp = timed(hard, rpkt, cam)
    target = jnp.zeros((H, W, 3), jnp.float32)

    def soft(transforms):
        def loss(tr):
            out = rz.rasterize(rpkt.replace(transforms=tr), cam, cfg,
                               soft=True, row_chunk=8)
            return jnp.mean((out - target) ** 2)
        return jax.value_and_grad(loss)(transforms)

    sc, ss, (sl, sg), scomp = timed(soft, rpkt.transforms, reps=1)
    finite = bool(np.isfinite(np.asarray(sg)).all())
    ok = (np.isfinite(np.asarray(img)).all() and finite
          and np.isfinite(float(sl)))
    return {"ok": bool(ok), "shape": [H, W], "supersample": 2,
            "triangles": int(rpkt.num_triangles),
            "hard_s": ts, "hard_compile_s": tc,
            "hard_temp_bytes": temp_bytes(comp),
            "soft_fwd_bwd_s": ss, "soft_compile_s": sc,
            "soft_temp_bytes": temp_bytes(scomp), "soft_grads_finite": finite,
            "peak_bytes": device.peak_bytes()}


def phase_tests():
    import pytest

    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      *[os.path.join(ROOT, f) for f in GPU_TEST_FILES]])
    return {"ok": rc == 0, "pytest_rc": int(rc)}


# ---------------------------------------------------------------- 4 cards


def phase_multi():
    from ptre.models import demo
    from ptre.ops import rng
    from ptre.parallel import sharding as sh
    from ptre.render import pathtracer as pt
    from ptre.render import rasterizer as rz
    from ptre.render import train
    from ptre.utils.config import RasterConfig

    devs = jax.devices()
    assert len(devs) == 4, devs
    dp = 4
    W, H = DEMO_WH
    scn = demo.reference_demo_scene(32, 16)
    pkt, cam, cfg, key = _setup(scn, W, H)
    # unclamped, as `train.mse_step` integrates, so its loss is comparable
    cfg = cfg.__class__(width=W, height=H, clamp_samples=False)
    rpkt = scn.build_packet(spheres_as_triangles=True)
    rcfg = RasterConfig(width=W, height=H, supersample=2)
    mesh = sh.make_mesh((dp, 1))
    rows = H // dp
    params = sh.differentiable_params(pkt, cam)
    target_img = jnp.full((H, W, 3), 0.25, jnp.float32)
    target = sh.to_shard_order(target_img, dp)
    out = {"mesh": [dp, 1], "shape": [H, W]}

    # --- sharded train step vs the one-card replay of its shards --------
    step = sh.make_train_step(mesh, cam, cfg)
    t0 = time.perf_counter()
    loss, grads, _ = jax.block_until_ready(step(params, pkt, target, key))
    out["train_first_call_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss, grads, _ = jax.block_until_ready(step(params, pkt, target, key))
    out["train_step_s"] = time.perf_counter() - t0

    card0 = devs[0]

    @jax.jit
    def replay(params):
        def total(params):
            pk, cm = sh._apply_params(params, pkt, cam)
            losses = []
            for i in range(dp):
                lkey = rng.fold(key, i * 131071)
                img = sh._sample_rows(rng.fold(lkey, 0), pk, cm, cfg,
                                      float(i), rows, dp)
                img = img.reshape(rows, W, 3)
                sse = jnp.sum((img - target[i * rows:(i + 1) * rows]) ** 2)
                losses.append(sse * (float(dp) / float(H * W * 3)))
            return sum(losses) / dp
        return jax.value_and_grad(total)(params)

    with jax.default_device(card0):
        rloss, rgrads = replay(jax.device_put(params, card0))
    out["train_loss"] = float(loss)
    out["train_loss_rel"] = abs(float(loss) - float(rloss)) / abs(float(rloss))
    out["train_grad_rel_l2"] = {k: rel_l2(grads[k], rgrads[k])
                                for k in rgrads}
    # the single-card mse_step on the same key draws other samples (the
    # sharded step folds a key per shard): its loss agrees statistically
    with jax.default_device(card0):
        mloss, _ = train.mse_step(params, pkt, cam,
                                  target_img.reshape(-1, 3), key, cfg)
    out["mse_step_loss_rel"] = (abs(float(loss) - float(mloss))
                                / abs(float(mloss)))

    # --- dual pipeline vs the one-card raster and render ---------------
    accum = pt.AccumState(linear=jnp.zeros((H, W, 3), jnp.float32),
                          frame=jnp.zeros((), jnp.int32))
    dual = jax.jit(lambda pkt, rpkt, accum, key: sh.dual_pipeline_step(
        mesh, pkt, rpkt, cam, accum, key, cfg, rcfg))
    acc_out, ras = jax.block_until_ready(dual(pkt, rpkt, accum, key))
    t0 = time.perf_counter()
    acc_out, ras = jax.block_until_ready(dual(pkt, rpkt, accum, key))
    out["dual_step_s"] = time.perf_counter() - t0

    with jax.default_device(card0):
        ras1 = rz.rasterize_jit(rpkt, cam, rcfg)
        ren1 = jax.jit(lambda: jnp.concatenate([
            sh._sample_rows(rng.fold(rng.fold(rng.fold(key, i * 131071), 0),
                                     1), pkt, cam, cfg, float(i), rows, dp)
            .reshape(rows, W, 3) for i in range(dp)]))()
    ras_img = np.asarray(sh.to_image_order(ras, dp, H))
    ras_px = np.abs(ras_img - np.asarray(ras1)).max(axis=-1) > 1e-5
    out["dual_raster_px_differ"] = int(ras_px.sum())
    out["dual_render"] = image_diff(acc_out.linear, ren1)

    # --- each shard on its own card --------------------------------------
    placement = {}
    for name, arr in (("accum", acc_out.linear), ("raster", ras)):
        shards = arr.addressable_shards
        placement[name] = sorted(s.device.id for s in shards)
        assert len({s.device for s in shards}) == dp, name
        assert all(s.data.shape[0] == rows for s in shards), name
        assert all(s.data.device == s.device for s in shards), name
    out["shard_devices"] = placement

    ok = (out["train_loss_rel"] <= MULTI_MAX_REL
          and max(out["train_grad_rel_l2"].values()) <= MULTI_MAX_REL
          and ras_px.mean() <= RASTER_MAX_FRAC_PX
          and out["dual_render"]["frac_px_gt"] <= FWD_MAX_FRAC_PX
          and out["dual_render"]["mean_abs"] <= FWD_MAX_MEAN_ABS)
    out["ok"] = bool(ok)
    return out


PHASES = {"device": phase_device, "fwd_demo": phase_fwd_demo,
          "fwd_tri": phase_fwd_tri, "train": phase_train,
          "xdev": phase_xdev, "raster": phase_raster, "tests": phase_tests}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="four cards: the sharded train step and the dual "
                        "pipeline against one card, and nothing else")
    args = p.parse_args(argv)

    from ptre.utils import device

    device.require_gpu()  # exits nonzero, printing no result
    names = ["device", "multi"] if args.multi else list(PHASES)
    phases = dict(PHASES, multi=phase_multi)
    failed = []
    for name in names:
        t0 = time.perf_counter()
        try:
            res = phases[name]()
        except Exception as exc:  # reported, and the run exits nonzero
            traceback.print_exc()
            res = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        res.setdefault("ok", True)
        res["phase"] = name
        res["wall_s"] = time.perf_counter() - t0
        emit(res)
        if not res["ok"]:
            failed.append(name)
            if name == "device":
                break
    if failed:
        emit({"ok": False, "failed": failed})
        return 1
    emit({"ok": True, "device": device.device_info()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
