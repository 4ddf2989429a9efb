"""Z-buffered triangle rasterizer (supersampled, differentiable-friendly).

JAX equivalent of the reference D3D11 hardware rasterizer
(`IoniqRE/rasterizer.{h,cu}` + `vertex_shader.hlsl` / `pixel_shader.hlsl`):
the fixed-function pipeline becomes a vectorized coverage/z-test/shade pass
over (pixel samples × triangles), z-buffer LESS test (`rasterizer.cu:77-83`),
clockwise-front back-face culling (`rasterizer.cu:117-124`), and a
supersample→box-resolve pass standing in for 4× MSAA + ResolveSubresource
(`rasterizer.cu:31,136-147`).

Shading matches the HLSL exactly:
  * VS: pos @ model → world; @ view @ projection → clip; w-divide; viewport.
    world_normal = normalize(n @ normal_matrix(model)).
  * PS: ambient 0.2 × sky(0.62, 0.84, 1.0) + directional diffuse
    max(dot(-n, light_dir), 0) with light_dir (0,-1,0), red albedo.

Clear color is the sky blue (`renderer_base.cu:30`), clear depth 1.0
(`rasterizer.cu:131-133`). Near-plane handling approximates clipping by
rejecting samples from triangles with any vertex at w <= 0 (the reference
relies on D3D clip; demo scenes keep geometry in front of the camera).

The hard rasterizer uses step-function coverage (piecewise-constant in
geometry — gradients flow through shading/depth but not silhouette edges).
`soft=True` swaps coverage for sigmoid edge distances and the z-test for a
softmax blend (SoftRas-style) so silhouettes become differentiable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ptre.ops import vecmat as vm
from ptre.utils.config import RasterConfig


def transform_vertices(tri_v, tri_n, tri_dc, transforms, view, proj):
    """Vertex stage for (T, 3, 3) triangle corners (vertex_shader.hlsl).

    Returns screen-ish clip info: ndc xyz after w-divide, w, world normals.
    """
    tf = transforms[tri_dc]  # (T, 4, 4)
    nm = vm.normal_matrix(tf)
    world = vm.einsum("tvi,tij->tvj", tri_v, tf[:, :3, :3]) + tf[:, None, 3, :3]
    n_world = vm.einsum("tvi,tij->tvj", tri_n, nm)
    n_world = vm.normalize(n_world)

    vp = vm.matmul(view, proj)
    clip = vm.einsum("tvi,ij->tvj", world, vp[:3, :3]) + vp[3, :3]
    w = vm.einsum("tvi,i->tv", world, vp[:3, 3]) + vp[3, 3]
    ndc = clip / w[..., None]
    return ndc, w, n_world


def shade(normals, config: RasterConfig):
    """Pixel stage (pixel_shader.hlsl): ambient + directional diffuse."""
    light_dir = vm.normalize(jnp.asarray(config.light_dir, jnp.float32))
    ambient = config.ambient_strength * jnp.asarray(config.clear_color, jnp.float32)
    diffuse = jnp.maximum(-vm.einsum("...k,k->...", normals, light_dir), 0.0)
    albedo = jnp.asarray(config.albedo, jnp.float32)
    return (ambient + diffuse[..., None]) * albedo


def _barycentrics(px, py, x0, y0, x1, y1, x2, y2, inv_area):
    """Edge-function barycentrics of sample points (px, py) (broadcasting)."""
    w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area
    w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area
    return w0, w1, 1.0 - w0 - w1


def _shade_interp(w0, w1, w2, iw, normals, config):
    """Perspective-correct normal interpolation (hardware attribute
    interpolation) then the pixel stage. ``iw`` (..., 3) and ``normals``
    (..., 3, 3) broadcast against the barycentrics' shape.

    The interpolated normal is (sum_i w_i n_i / w_clip_i) / denom; only its
    direction is used, so it is normalized before the division and the
    denominator contributes its sign alone. Identical for denom != 0, and
    finite (value and gradient) where a far (sample, triangle) pair of the
    soft blend has denom == 0, which would otherwise be inf / NaN."""
    denom = w0 * iw[..., 0] + w1 * iw[..., 1] + w2 * iw[..., 2]
    n = (
        w0[..., None] * (normals[..., 0, :] * iw[..., 0, None])
        + w1[..., None] * (normals[..., 1, :] * iw[..., 1, None])
        + w2[..., None] * (normals[..., 2, :] * iw[..., 2, None])
    )
    return shade(vm.normalize(n) * jnp.sign(denom)[..., None], config)


def _raster_tile(sx, sy, screen, depth01, w, normals, valid, config, soft, sigma):
    """Rasterize all triangles onto one flat batch of sample points.

    Args:
      sx, sy: (P,) sample coordinates in supersampled screen space.
      screen: (T, 3, 2) screen-space xy per corner; depth01: (T, 3) NDC z.
      w: (T, 3) clip w (for perspective-correct attributes + near reject).
      normals: (T, 3, 3) world normals.
      valid: (T,) triangle mask.
    Returns (P, 3) color.
    """
    x0, y0 = screen[:, 0, 0], screen[:, 0, 1]
    x1, y1 = screen[:, 1, 0], screen[:, 1, 1]
    x2, y2 = screen[:, 2, 0], screen[:, 2, 1]

    # signed area: positive = clockwise in y-down screen space = front face
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    front = area > 0.0
    keep = valid & (jnp.min(w, axis=1) > 0.0)
    if config.cull_backfaces:
        keep = keep & front
    else:
        keep = keep & (jnp.abs(area) > 0.0)

    # sanitize dropped triangles: behind-camera (w <= 0) rows carry NaN/inf
    # screen coords from the w-divide, and NaN survives masked arithmetic
    # (0 * NaN = NaN) through the soft coverage/softmax blend
    def _san(v, fill=0.0):
        return jnp.where(keep, v, fill)

    x0, y0, x1, y1, x2, y2 = map(_san, (x0, y0, x1, y1, x2, y2))
    depth01 = jnp.where(keep[:, None], depth01, 0.5)
    w = jnp.where(keep[:, None], w, 1.0)
    normals = jnp.where(keep[:, None, None], normals, 0.0)
    area = _san(area, 1.0)

    inv_area = 1.0 / jnp.where(area == 0.0, 1.0, area)
    iw = 1.0 / w  # (T, 3)

    # edge functions at every (sample, triangle) pair → barycentrics
    px = sx[:, None]
    py = sy[:, None]
    w0, w1, w2 = _barycentrics(px, py, x0, y0, x1, y1, x2, y2, inv_area)

    z = w0 * depth01[None, :, 0] + w1 * depth01[None, :, 1] + w2 * depth01[None, :, 2]
    z_ok = (z >= 0.0) & (z <= 1.0)
    clear = jnp.asarray(config.clear_color, jnp.float32)

    if not soft:
        inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
        covered = inside & z_ok & keep[None, :]
        zbuf = jnp.where(covered, z, jnp.inf)
        best = jnp.argmin(zbuf, axis=1)  # z-buffer LESS (`rasterizer.cu:80`)
        any_hit = jnp.any(covered, axis=1)
        # deferred winner: interpolate and shade only the triangle that won
        # the z-test, not every (sample, triangle) pair
        g = [a[best] for a in (x0, y0, x1, y1, x2, y2, inv_area)]
        b0, b1, b2 = _barycentrics(sx, sy, *g)
        color = _shade_interp(b0, b1, b2, iw[best], normals[best], config)
        return jnp.where(any_hit[:, None], color, clear)

    color = _shade_interp(w0, w1, w2, iw[None], normals[None], config)

    # SoftRas-style: sigmoid coverage on signed edge distance, softmax depth
    def edge_dist(ax, ay, bx, by):
        ex, ey = bx - ax, by - ay
        t = ((px - ax[None]) * ex[None] + (py - ay[None]) * ey[None]) / (
            ex * ex + ey * ey + 1e-12
        )[None]
        t = jnp.clip(t, 0.0, 1.0)
        cx = ax[None] + t * ex[None]
        cy = ay[None] + t * ey[None]
        return jnp.sqrt((px - cx) ** 2 + (py - cy) ** 2 + 1e-12)

    d01 = edge_dist(x0, y0, x1, y1)
    d12 = edge_dist(x1, y1, x2, y2)
    d20 = edge_dist(x2, y2, x0, y0)
    dist = jnp.minimum(d01, jnp.minimum(d12, d20))
    inside = (w0 >= 0.0) & (w1 >= 0.0) & (w2 >= 0.0)
    signed = jnp.where(inside, dist, -dist)
    cov = jax.nn.sigmoid(signed / sigma) * keep[None, :] * z_ok

    zc = jnp.clip(z, 0.0, 1.0)
    logits = -zc / 0.01  # nearer → larger weight
    weights = cov * jax.nn.softmax(jnp.where(cov > 1e-6, logits, -1e9), axis=1)
    total = jnp.sum(weights, axis=1, keepdims=True)
    bg = jnp.maximum(0.0, 1.0 - total)
    out = vm.einsum("pt,ptc->pc", weights, color) + bg * clear
    return out


def rasterize(
    packet,
    cam,
    config: RasterConfig,
    soft: bool = False,
    sigma: float = 0.5,
    row_chunk: int = 0,
):
    """Rasterize a ScenePacket (built with spheres_as_triangles=True) → (H, W, 3).

    Follows the reference frame: supersampled render target, per-drawcall
    transforms (`rasterizer.cu:155-169`), box resolve (`rasterizer.cu:142`).
    ``row_chunk`` > 0 processes that many supersampled rows per `lax.map` step
    to bound the (samples × triangles) intermediate.
    """
    return raster_rows(packet, cam, config, 0.0, config.height, soft=soft,
                       sigma=sigma, row_chunk=row_chunk)


def raster_rows(packet, cam, config: RasterConfig, y0, rows,
                soft: bool = False, sigma: float = 0.5, row_chunk: int = 0,
                stride: int = 1):
    """Rasterize ``rows`` output rows y0, y0+stride, ... → (rows, W, 3),
    supersampled + resolved.

    Pixel rows are independent given the transformed triangles (the
    z-buffer test is per-pixel), which makes this the dp-sharding unit for
    the multi-chip rasterizer (`parallel.sharding.shard_raster_step`):
    every chip runs the identical (cheap, T-sized) vertex stage and
    rasterizes only its own rows. ``y0`` may be traced (per-chip offset);
    ``stride=dp`` is the interleaved (load-balanced) dp assignment.

    ``row_chunk``: see `rasterize`. Each chunk is rematerialized in the
    backward pass, so a differentiable (soft) raster keeps one chunk's
    (samples × triangles) residuals live at a time.
    """
    ss = config.supersample
    W, H = config.width * ss, config.height * ss

    view = cam.view_matrix()
    proj = cam.projection_matrix()
    tri_v = jnp.stack([packet.tri_v0, packet.tri_v1, packet.tri_v2], axis=1)
    tri_n = jnp.stack([packet.tri_n0, packet.tri_n1, packet.tri_n2], axis=1)
    ndc, w, n_world = transform_vertices(
        tri_v, tri_n, packet.tri_dc, packet.transforms, view, proj
    )

    # viewport transform: NDC → supersampled pixel coords (y flip)
    sx = (ndc[..., 0] + 1.0) * 0.5 * W
    sy = (1.0 - ndc[..., 1]) * 0.5 * H
    screen = jnp.stack([sx, sy], axis=-1)
    depth01 = ndc[..., 2]

    Hw = rows * ss  # supersampled rows in this window
    xs = (jnp.arange(W, dtype=jnp.float32) + 0.5)
    # output rows y0, y0+stride, ...; each contributes ss supersampled rows
    out_rows = (jnp.asarray(y0, jnp.float32)
                + float(stride) * jnp.arange(rows, dtype=jnp.float32))
    ys = (out_rows[:, None] * ss
          + jnp.arange(ss, dtype=jnp.float32)[None, :] + 0.5).reshape(-1)
    gy, gx = jnp.meshgrid(ys, xs, indexing="ij")

    def run_rows(rows_xy):
        gxr, gyr = rows_xy
        return _raster_tile(
            gxr.reshape(-1), gyr.reshape(-1), screen, depth01, w, n_world,
            packet.tri_valid, config, soft, sigma,
        )

    if row_chunk and Hw > row_chunk:
        assert Hw % row_chunk == 0, (Hw, row_chunk)
        chunks = Hw // row_chunk
        gxc = gx.reshape(chunks, row_chunk * W)
        gyc = gy.reshape(chunks, row_chunk * W)
        img = jax.lax.map(jax.checkpoint(run_rows),
                          (gxc, gyc)).reshape(Hw, W, 3)
    else:
        img = run_rows((gx, gy)).reshape(Hw, W, 3)

    # MSAA-style box resolve (`rasterizer.cu:142` ResolveSubresource)
    img = img.reshape(rows, ss, config.width, ss, 3).mean(axis=(1, 3))
    return img


@functools.partial(
    jax.jit, static_argnames=("config", "soft", "sigma", "row_chunk")
)
def rasterize_jit(packet, cam, config, soft=False, sigma=0.5, row_chunk=0):
    return rasterize(packet, cam, config, soft, sigma, row_chunk)


@functools.partial(jax.jit, static_argnames=("config",))
def rasterize_frames(packet, cam, frame_transforms, config):
    """Render K frames in ONE device dispatch → (K, H, W, 3).

    ``frame_transforms``: (K, D, 4, 4) — one per-drawcall transform set per
    frame (the reference's per-frame animation state, `rasterizer.cu:
    155-169`); frame k renders ``packet.replace(transforms=
    frame_transforms[k])`` via `lax.scan`. This is the CLI frame-sequence
    path's batched form: K frames cost one dispatch and one host sync
    instead of K."""
    def body(carry, tr):
        img = rasterize(packet.replace(transforms=tr), cam, config)
        return carry, img

    _, imgs = jax.lax.scan(body, 0, frame_transforms)
    return imgs
