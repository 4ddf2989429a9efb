"""Multi-device rendering + training over a jax.sharding.Mesh.

The reference is single-process single-GPU — its only "transport" is
CPU↔GPU memcpy (`scene.cu:183-233`, `path_tracer.cu:385`). The scaling
design (SURVEY §2 parallelism table, BASELINE north star):

  * ``dp`` axis: pixel-row data parallelism — each device owns a set of
    image rows; the scene packet is replicated (it is small and every ray
    may touch every primitive), so the forward pass needs ZERO cross-device
    communication during the bounce loop.
  * ``sp`` axis: sample parallelism — samples-per-pixel divided across
    devices; progressive accumulation is a device-local reduction, combined
    by a single ``psum`` mean at the end of a launch.
  * Gradients: each device back-propagates its pixel/sample shard;
    parameter gradients are ``psum``-all-reduced over both axes — the only
    collective in the training step.

Implemented with ``jax.shard_map`` so the collectives are explicit and the
per-chip code is exactly the single-chip path (same kernels, no resharding).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ptre.ops import camera as cam_ops
from ptre.ops import gradsafe, integrator, rng
from ptre.render import pathtracer as pt
from ptre.utils.config import RenderConfig


def make_mesh(shape: Optional[Tuple[int, int]] = None, devices=None) -> Mesh:
    """Create a ("dp", "sp") device mesh over all (or given) devices.

    A plain reshape of the device list: the GPUs of one host are joined all
    to all, so no device order is better than another."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if shape is None:
        shape = (n, 1)
    assert shape[0] * shape[1] == n, (shape, n)
    return Mesh(np.asarray(devices, dtype=object).reshape(shape), ("dp", "sp"))


#: default dp row assignment. "strided" interleaves rows round-robin (chip i
#: takes image rows i, i+dp, i+2dp, ...) so every chip sees the same mix of
#: sky rows and geometry rows — contiguous "block" slabs concentrate the
#: cheap sky rows (early-terminating paths) on some chips, and that load
#: imbalance bounds the >=85% scaling north star. Strided also lifts the
#: height % dp == 0 restriction:
#: the row space is padded to dp * ceil(H / dp) and pad rows are masked.
ROW_ORDER_DEFAULT = "strided"


def padded_height(height: int, dp_size: int) -> int:
    """Sharded row-space height: dp * ceil(H / dp) (== H when dp | H)."""
    return dp_size * (-(-height // dp_size))


def _local_rows(cam: cam_ops.Camera, dp_size: int):
    return padded_height(cam.height, dp_size) // dp_size


def shard_row_ids(dp_i, rows: int, dp_size: int, row_order: str):
    """Image-row indices owned by dp-chip ``dp_i`` (float32 (rows,));
    strided → dp_i, dp_i+dp, ...; block → dp_i*rows .. dp_i*rows+rows-1.
    Indices >= H are padding (rendered but masked/discarded)."""
    ar = jnp.arange(rows, dtype=jnp.float32)
    dp_f = jnp.asarray(dp_i, jnp.float32)
    if row_order == "strided":
        return dp_f + float(dp_size) * ar
    return dp_f * float(rows) + ar


def to_image_order(arr, dp_size: int, height: int,
                   row_order: str = ROW_ORDER_DEFAULT):
    """Shard-layout rows (Hpad, ...) → image order (height, ...).

    The step functions keep accumulators/targets in SHARD layout: shard i
    owns the contiguous slab [i*rows, (i+1)*rows) holding ITS image rows
    (interleaved for "strided"). This is the one gather at display time the
    strided assignment costs; for "block" it is a pure slice.
    """
    hp = arr.shape[0]
    rows = hp // dp_size
    if row_order == "strided":
        # slab k of shard i holds image row k*dp + i
        arr = arr.reshape((dp_size, rows) + arr.shape[1:])
        arr = jnp.swapaxes(arr, 0, 1).reshape((hp,) + arr.shape[2:])
    return arr[:height]


def to_shard_order(img, dp_size: int, row_order: str = ROW_ORDER_DEFAULT):
    """Image-order rows (H, ...) → shard layout (Hpad, ...), zero-padded."""
    h = img.shape[0]
    hp = padded_height(h, dp_size)
    if hp != h:
        img = jnp.concatenate(
            [img, jnp.zeros((hp - h,) + img.shape[1:], img.dtype)], axis=0)
    if row_order == "strided":
        rows = hp // dp_size
        img = img.reshape((rows, dp_size) + img.shape[1:])
        img = jnp.swapaxes(img, 0, 1).reshape((hp,) + img.shape[2:])
    return img


def _sample_rows(key, packet, cam, config, y0, rows, stride: int = 1):
    """One jittered sample for `rows` image rows y0, y0+stride, ... →
    (rows*W, 3). ``stride=dp`` is the strided dp assignment; 1 = block."""
    py, px = jnp.meshgrid(
        jnp.asarray(y0, jnp.float32)
        + float(stride) * jnp.arange(rows, dtype=jnp.float32),
        jnp.arange(cam.width, dtype=jnp.float32),
        indexing="ij",
    )
    px, py = px.reshape(-1), py.reshape(-1)
    jitter = rng.pixel_jitter(rng.fold(key, 0x9E37), (px.shape[0],))
    o, d = cam_ops.get_rays(cam, px, py, jitter)
    color = integrator.trace(key, o, d, packet, config)
    return integrator.postprocess_sample(color, config.clamp_samples)


def _row_start_stride(dp_i, rows: int, dp_size: int, row_order: str):
    """(y0, stride) for `_sample_rows`/`raster_rows` under a row order."""
    if row_order == "strided":
        return dp_i.astype(jnp.float32), dp_size
    return (dp_i * rows).astype(jnp.float32), 1


def shard_render_step(
    mesh: Mesh,
    packet,
    cam: cam_ops.Camera,
    accum: pt.AccumState,
    key,
    config: RenderConfig,
    spp: int = 1,
    row_order: str = ROW_ORDER_DEFAULT,
):
    """Progressive render step sharded (rows over dp, samples over sp).

    ``accum.linear`` is sharded over rows IN SHARD LAYOUT — its first
    dimension is ``padded_height(H, dp)`` and shard i's slab holds the image
    rows `shard_row_ids` assigns it (interleaved under the default
    "strided" order; convert for display with `to_image_order`). The
    packet/camera are replicated. Each chip accumulates its own rows; along
    ``sp`` each chip renders spp/sp_size samples and the running averages
    are psum-averaged so the result equals the single-chip running average
    over all spp samples (up to sample ordering in the average, which the
    mean makes exact).
    """
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    assert spp % sp == 0, (spp, sp)
    local_spp = spp // sp
    rows = _local_rows(cam, dp)
    assert accum.linear.shape[0] == rows * dp, (
        accum.linear.shape, padded_height(cam.height, dp))

    def local_step(packet, linear, frame, key):
        dp_i = jax.lax.axis_index("dp")
        sp_i = jax.lax.axis_index("sp")
        y0, stride = _row_start_stride(dp_i, rows, dp, row_order)
        lkey = rng.fold(key, dp_i * 131071 + sp_i)

        # chip-local progressive accumulation of local_spp samples starting
        # from the shared global counter (`path_tracer.cu:356-358`)
        def body(carry, s):
            lin, n = carry
            n1 = n + 1
            skey = rng.fold(rng.fold(lkey, s), n1)
            img = _sample_rows(skey, packet, cam, config, y0, rows, stride)
            img = img.reshape(rows, cam.width, 3)
            n1f = n1.astype(jnp.float32)
            lin = img / n1f + lin * ((n1f - 1.0) / n1f)
            return (lin, n1), None

        (lin, n), _ = jax.lax.scan(body, (linear, frame), jnp.arange(local_spp))
        # combine the sp chips' independent running averages (they carry
        # equal sample counts → plain mean keeps the running-average meaning)
        lin = jax.lax.pmean(lin, "sp")
        n = frame + local_spp * sp
        return lin, n

    linear, frame = jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P("dp", None, None), P(), P()),
        out_specs=(P("dp", None, None), P()),
        check_vma=False,
    )(packet, accum.linear, accum.frame, key)
    return pt.AccumState(linear=linear, frame=frame)


def differentiable_params(packet, cam: cam_ops.Camera):
    """The sweepable/differentiable parameter pytree (BASELINE configs 4-5)."""
    return {
        "transforms": packet.transforms,
        "sph_center": packet.sph_center,
        "sph_radius": packet.sph_radius,
        "mat_albedo": packet.mat_albedo,
        "mat_param": packet.mat_param,
        "sky_bottom": packet.sky_bottom,
        "sky_top": packet.sky_top,
        "cam_position": cam.position,
        "cam_forward": cam.forward,
        "cam_fov": cam.fov_degrees,
    }


def _apply_params(params, packet, cam):
    packet = packet.replace(
        transforms=params["transforms"],
        sph_center=params["sph_center"],
        sph_radius=params["sph_radius"],
        mat_albedo=params["mat_albedo"],
        mat_param=params["mat_param"],
        sky_bottom=params["sky_bottom"],
        sky_top=params["sky_top"],
    )
    cam = cam.replace(
        position=params["cam_position"],
        forward=params["cam_forward"],
        fov_degrees=params["cam_fov"],
    )
    return packet, cam


def shard_train_step(
    mesh: Mesh,
    params,
    packet,
    cam: cam_ops.Camera,
    target,
    key,
    config: RenderConfig,
    spp: int = 1,
    lr: float = 0.0,
    row_order: str = ROW_ORDER_DEFAULT,
):
    """One forward+backward step: L2 image loss vs `target`, grads psum'd.

    Rows shard over dp, samples over sp; the scene is replicated so the only
    collectives are the loss/grad psums (overlappable with backward by XLA).
    ``target`` must be in SHARD LAYOUT (`to_shard_order`) — shape
    (padded_height(H, dp), W, 3); pad rows are masked out of the loss, so
    the loss equals the image MSE over the true H rows exactly.
    Returns (loss, grads, new_params); ``lr`` > 0 also applies SGD.
    """
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    assert spp % sp == 0
    local_spp = spp // sp
    rows = _local_rows(cam, dp)
    n_valid = float(cam.height * cam.width * 3)  # global loss normalizer

    def local_loss(params, packet, target_rows, key):
        dp_i = jax.lax.axis_index("dp")
        sp_i = jax.lax.axis_index("sp")
        y0, stride = _row_start_stride(dp_i, rows, dp, row_order)
        lkey = rng.fold(key, dp_i * 131071 + sp_i)
        pkt, lcam = _apply_params(params, packet, cam)

        def body(acc, s):
            img = _sample_rows(rng.fold(lkey, s), pkt, lcam, config, y0, rows,
                               stride)
            return acc + img.reshape(rows, cam.width, 3), None

        if local_spp == 1:
            # no scan for a single sample: a length-1 grad-of-scan still
            # materializes every body intermediate as a while-loop residual
            # (hard fusion boundary)
            acc, _ = body(jnp.zeros((rows, cam.width, 3), jnp.float32), 0)
        else:
            if config.remat_bounces:
                # sample-level remat: keep ONE sample's backward residuals
                # live at a time (the scan would otherwise store local_spp of
                # them — 64 samples' bounce residuals at 1080p)
                body = jax.checkpoint(body, policy=gradsafe.remat_policy)

            acc, _ = jax.lax.scan(
                body, jnp.zeros((rows, cam.width, 3), jnp.float32),
                jnp.arange(local_spp)
            )
        img = jax.lax.pmean(acc / local_spp, "sp")
        # masked sum of squared errors, scaled so the dp-mean of the
        # per-chip terms is EXACTLY the global image MSE over the true H
        # rows (pad rows from odd heights contribute zero); for dp | H this
        # reduces to the per-shard mean
        ys = y0 + float(stride) * jnp.arange(rows, dtype=jnp.float32)
        mask = (ys < float(cam.height)).astype(jnp.float32)[:, None, None]
        sse = jnp.sum(mask * (img - target_rows) ** 2)
        return sse * (float(dp) / n_valid)

    def local_step(params, packet, target_rows, key):
        loss, grads = jax.value_and_grad(local_loss)(params, packet, target_rows, key)
        # combine shard gradients: the in-scan pmean over sp back-propagates
        # as a psum of the (replicated) cotangent, so each chip's grad comes
        # out sp-fold too large; pmean over both axes restores the gradient
        # of the global mean loss — validated numerically against a
        # single-device replay in tests/test_parallel.py
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, ("dp", "sp")), grads)
        return jax.lax.pmean(loss, "dp"), grads

    # jit is REQUIRED here (not just an optimization): the sample-level
    # jax.checkpoint inside local_loss lowers to closed_call, which eager
    # shard_map cannot evaluate
    loss, grads = jax.jit(jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(), P(), P("dp", None, None), P()),
        out_specs=(P(), P()),
        check_vma=False,
    ))(params, packet, target, key)

    new_params = (
        jax.tree.map(lambda p, g: p - lr * g, params, grads) if lr else params
    )
    return loss, grads, new_params


def shard_raster_step(mesh: Mesh, packet, cam: cam_ops.Camera, config,
                      soft: bool = False, sigma: float = 0.5,
                      row_order: str = ROW_ORDER_DEFAULT):
    """Rasterize with pixel rows sharded over the dp axis → SHARD-layout
    (padded_height(H, dp), W, 3); convert with `to_image_order` for display.

    The z-buffer test is per-pixel, so rows are independent given the
    transformed triangles: every chip runs the identical (T-sized, cheap)
    vertex stage on the replicated packet and rasterizes only its own rows
    — ZERO collectives, the rasterizer analogue of the path tracer's
    pixel-row sharding (BASELINE config 5 "tiles sharded across multi-host
    pod"; reference analogue `rasterizer.cu:155-169`, one draw over one
    scene). ``soft=True`` shards the differentiable SoftRas variant the
    same way.
    """
    from ptre.render import rasterizer as rz

    dp = mesh.shape["dp"]
    rows = padded_height(config.height, dp) // dp

    def local(packet):
        dp_i = jax.lax.axis_index("dp")
        y0, stride = _row_start_stride(dp_i, rows, dp, row_order)
        return rz.raster_rows(packet, cam, config, y0, rows, soft=soft,
                              sigma=sigma, stride=stride)

    return jax.shard_map(
        local, mesh=mesh, in_specs=(P(),),
        out_specs=P("dp", None, None), check_vma=False,
    )(packet)


def dual_pipeline_step(mesh: Mesh, packet, raster_packet, cam: cam_ops.Camera,
                       accum: pt.AccumState, key, config: RenderConfig,
                       raster_config, spp: int = 1,
                       row_order: str = ROW_ORDER_DEFAULT):
    """BASELINE config 5: rasterizer pass + path-traced pass over the SAME
    scene and camera, both row-sharded over the mesh.

    The reference's two engines share one scene/camera and are toggled live
    (`renderer.cu:45-78`); here both run per frame: the z-buffer pass gives
    the instant preview frame, the path-traced pass advances the
    progressive accumulator. Returns (accum', raster_img), each sharded
    over dp rows in SHARD layout (`to_image_order` for display).
    """
    accum = shard_render_step(mesh, packet, cam, accum, key, config, spp=spp,
                              row_order=row_order)
    raster = shard_raster_step(mesh, raster_packet, cam, raster_config,
                               row_order=row_order)
    return accum, raster


def dual_train_step(mesh: Mesh, params, packet, raster_packet,
                    cam: cam_ops.Camera, target, key, config: RenderConfig,
                    raster_config, spp: int = 1, raster_weight: float = 0.5,
                    sigma: float = 0.5, row_order: str = ROW_ORDER_DEFAULT):
    """Differentiable dual-pipeline step: L2 of the path-traced image plus
    L2 of the SOFT (differentiable) rasterizer image against the same
    row-sharded target (SHARD layout, see `to_shard_order`); gradients
    from BOTH pipelines psum-combined.

    The loss couples the pipelines through the shared parameters
    (transforms, camera): the rasterizer contributes silhouette-smooth
    geometry gradients where the detached-visibility path tracer has none.
    Returns (loss, grads).
    """
    from ptre.render import rasterizer as rz

    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    assert spp % sp == 0
    local_spp = spp // sp
    rows = _local_rows(cam, dp)
    assert config.height == raster_config.height
    assert config.width == raster_config.width
    n_valid = float(cam.height * cam.width * 3)

    def local_loss(params, packet, raster_packet, target_rows, key):
        dp_i = jax.lax.axis_index("dp")
        sp_i = jax.lax.axis_index("sp")
        y0, stride = _row_start_stride(dp_i, rows, dp, row_order)
        lkey = rng.fold(key, dp_i * 131071 + sp_i)
        pkt, lcam = _apply_params(params, packet, cam)
        # raster packet shares the transform/camera leaves
        rpkt = raster_packet.replace(transforms=params["transforms"])

        def body(acc, s):
            img = _sample_rows(rng.fold(lkey, s), pkt, lcam, config, y0, rows,
                               stride)
            return acc + img.reshape(rows, cam.width, 3), None

        if local_spp == 1:
            acc, _ = body(jnp.zeros((rows, cam.width, 3), jnp.float32), 0)
        else:
            if config.remat_bounces:
                body = jax.checkpoint(body, policy=gradsafe.remat_policy)
            acc, _ = jax.lax.scan(
                body, jnp.zeros((rows, cam.width, 3), jnp.float32),
                jnp.arange(local_spp))
        pt_img = jax.lax.pmean(acc / local_spp, "sp")
        rz_img = rz.raster_rows(rpkt, lcam, raster_config, y0, rows,
                                soft=True, sigma=sigma, stride=stride)
        ys = y0 + float(stride) * jnp.arange(rows, dtype=jnp.float32)
        mask = (ys < float(cam.height)).astype(jnp.float32)[:, None, None]
        pt_loss = jnp.sum(mask * (pt_img - target_rows) ** 2) * (
            float(dp) / n_valid)
        rz_loss = jnp.sum(mask * (rz_img - target_rows) ** 2) * (
            float(dp) / n_valid)
        return pt_loss + raster_weight * rz_loss

    def local_step(params, packet, raster_packet, target_rows, key):
        loss, grads = jax.value_and_grad(local_loss)(
            params, packet, raster_packet, target_rows, key)
        grads = jax.tree.map(lambda g: jax.lax.pmean(g, ("dp", "sp")), grads)
        return jax.lax.pmean(loss, "dp"), grads

    return jax.jit(jax.shard_map(
        local_step, mesh=mesh,
        in_specs=(P(), P(), P(), P("dp", None, None), P()),
        out_specs=(P(), P()), check_vma=False,
    ))(params, packet, raster_packet, target, key)


def make_render_step(mesh: Mesh, cam: cam_ops.Camera, config: RenderConfig,
                     spp: int = 1, row_order: str = ROW_ORDER_DEFAULT):
    """Build a jit-compiled sharded progressive render step.

    `shard_render_step` constructs its shard_map closure per call, so calling
    it directly re-traces (and on a real backend re-compiles) every step.
    This factory closes over the static arguments once; the returned
    ``step(packet, accum, key) -> AccumState`` hits the jit cache from the
    second call on. Use this for frame loops and benchmarks.
    """

    @jax.jit
    def step(packet, accum: pt.AccumState, key) -> pt.AccumState:
        return shard_render_step(mesh, packet, cam, accum, key, config,
                                 spp=spp, row_order=row_order)

    return step


def make_train_step(mesh: Mesh, cam: cam_ops.Camera, config: RenderConfig,
                    spp: int = 1, lr: float = 0.0,
                    row_order: str = ROW_ORDER_DEFAULT):
    """Build a jit-compiled sharded forward+backward step (see
    `make_render_step` for why). Returns
    ``step(params, packet, target, key) -> (loss, grads, new_params)``.
    """

    @jax.jit
    def step(params, packet, target, key):
        return shard_train_step(mesh, params, packet, cam, target, key,
                                config, spp=spp, lr=lr, row_order=row_order)

    return step


def make_dual_train_step(mesh: Mesh, cam: cam_ops.Camera,
                         config: RenderConfig, raster_config, spp: int = 1,
                         raster_weight: float = 0.5, sigma: float = 0.5,
                         row_order: str = ROW_ORDER_DEFAULT):
    """Build a jit-compiled differentiable dual-pipeline step (see
    `make_render_step` for why — `dual_train_step` re-traces per call).
    Returns ``step(params, packet, raster_packet, target, key) ->
    (loss, grads)``."""

    @jax.jit
    def step(params, packet, raster_packet, target, key):
        return dual_train_step(mesh, params, packet, raster_packet, cam,
                               target, key, config, raster_config, spp=spp,
                               raster_weight=raster_weight, sigma=sigma,
                               row_order=row_order)

    return step


def replicate(mesh: Mesh, tree):
    """Place a pytree replicated over the mesh."""
    s = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, s), tree)


def shard_rows(mesh: Mesh, arr):
    """Place an (H, ...) array row-sharded over the dp axis."""
    s = NamedSharding(mesh, P("dp"))
    return jax.device_put(arr, s)
