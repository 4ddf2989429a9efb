"""Per-ray-block path-tracing kernel (Pallas, Triton route).

The reference renders a progressive sample as one CUDA launch: one thread
per pixel generates its jittered camera ray (`camera.cu:20-43`), runs the
whole bounce loop in registers with a brute-force loop over every primitive
per bounce (`path_tracer.cu:231-328`), then clamps, scrubs and folds the
sample into the running average (`path_tracer.cu:345-365`). This kernel is
that design for a GPU through Pallas: one program per block of ``BLOCK``
rays (pixels in row-major order), and inside it

  * ray generation through the same inverse projection / inverse view
    matrices as `ops.camera.get_rays`;
  * a bounce loop that stops as soon as every ray of the block has
    terminated (the reference's per-thread ``break``);
  * per bounce, a loop over the triangle table and then the sphere table in
    device memory (a 16k-triangle table is ~1.3 MB, resident in L2) that
    keeps only the closest t and its index; the winner's attributes come
    from an indexed load after the sweep;
  * Oren–Nayar / emissive scatter and the sky on a miss, formula for
    formula the staged XLA route (`ops.integrator.trace`);
  * the per-sample clamp + non-finite scrub and the running-average update
    of the (R, 3) accumulator, aliased in place.

Random numbers come from `jax.random` outside the kernel, drawn exactly as
the staged route draws them (`sample_uniforms`), so the kernel and the
reference consume identical jitter and scatter uniforms; they differ only in
float summation order. The kernel is forward-only: gradients take the staged
route.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ptre.ops import rng
from ptre.ops import vecmat as vm

#: rays per program, a power of two (Triton block shapes); 256 rays on 4
#: warps was the fastest of 64-256 rays on 1-8 warps on an H100 (PERF.md)
BLOCK = 256
#: warps per program
NUM_WARPS = 4

_BIG = 1e30
_PI = 3.141592653589793
_TAU = 2.0 * _PI

# triangle table columns: v0 (0-2), e1 (3-5), e2 (6-8), n0 (9-11),
# n1 (12-14), n2 (15-17), material (18), valid (19)
_TRI_COLS = 20
# sphere table columns: center (0-2), radius (3), material (4), valid (5)
_SPH_COLS = 6
# material table columns: kind (0), albedo (1-3), param (4)
_MAT_COLS = 5


def pack_tables(packet):
    """World-space primitive tables for the kernel: (tri, sph, mat, nt, ns).

    Rows are trimmed to the packet's true counts (static); an empty class
    gets one zero row and a count of 0, so its loop is skipped.
    """
    v0, v1, v2, n0, n1, n2 = packet.world_triangles()
    f32 = jnp.float32
    nt = int(packet.num_triangles)
    ns = int(packet.num_spheres)
    if nt:
        tri = jnp.concatenate([
            v0, v1 - v0, v2 - v0, n0, n1, n2,
            packet.tri_mat[:, None].astype(f32),
            packet.tri_valid[:, None].astype(f32)], axis=1)[:nt]
    else:
        tri = jnp.zeros((1, _TRI_COLS), f32)
    if ns:
        sph = jnp.concatenate([
            packet.sph_center, packet.sph_radius[:, None],
            packet.sph_mat[:, None].astype(f32),
            packet.sph_valid[:, None].astype(f32)], axis=1)[:ns]
    else:
        sph = jnp.zeros((1, _SPH_COLS), f32)
    mat = jnp.concatenate([
        packet.mat_kind[:, None].astype(f32), packet.mat_albedo,
        packet.mat_param[:, None]], axis=1)
    return tri, sph, mat, nt, ns


def sample_uniforms(key, n_rays: int, max_depth: int):
    """The random numbers of one sample, as the staged route draws them.

    Returns (jitter (R, 2) in [-0.5, 0.5), urand (2*max_depth, R)): rows
    [2b, 2b+1] of ``urand`` are bounce b's (u1, u2), drawn from
    ``split(fold(key, b))`` exactly like `materials.scatter` →
    `rng.cosine_weighted`; the jitter is `pathtracer.sample_image`'s.
    """
    jitter = rng.pixel_jitter(rng.fold(key, 0x9E37), (n_rays,))
    rows = []
    for b in range(max_depth):
        k1, k2 = jax.random.split(rng.fold(key, b))
        rows.append(jax.random.uniform(k1, (n_rays,), jnp.float32))
        rows.append(jax.random.uniform(k2, (n_rays,), jnp.float32))
    return jitter, jnp.stack(rows)


def camera_matrices(cam):
    """(32,) flattened inv(projection) then inv(view), as `get_rays` uses."""
    inv_view = vm.inverse(cam.view_matrix())
    inv_proj = vm.inverse(cam.projection_matrix())
    return jnp.concatenate([inv_proj.reshape(-1), inv_view.reshape(-1)])


def _normalize(x, y, z):
    """`vecmat.normalize`: zero vectors stay zero."""
    len_sq = x * x + y * y + z * z
    inv = jnp.where(len_sq > 0.0,
                    1.0 / jnp.sqrt(jnp.where(len_sq > 0.0, len_sq, 1.0)), 0.0)
    return x * inv, y * inv, z * inv


def _path_kernel(scal_ref, cam_ref, jit_ref, ur_ref, tri_ref, sph_ref,
                 mat_ref, acc_in_ref, acc_ref, *, n_rays, width, height,
                 n_tri, n_sph, max_depth, clamp, t_min, t_max, det_eps,
                 shadow_eps, pdf_eps):
    f32 = jnp.float32
    start = pl.program_id(0) * BLOCK
    idx = start + jnp.arange(BLOCK, dtype=jnp.int32)
    live = idx < n_rays
    rows = pl.ds(start, BLOCK)

    # ---- primary ray (`camera.get_rays`, `camera.cu:20-43`) -------------
    py_i = jax.lax.div(idx, jnp.int32(width))
    px = (idx - py_i * width).astype(f32)
    py = py_i.astype(f32)
    jx = plgpu.load(jit_ref.at[rows, 0], mask=live, other=0.0)
    jy = plgpu.load(jit_ref.at[rows, 1], mask=live, other=0.0)
    x_ndc = ((px + jx) / width) * 2.0 - 1.0
    y_ndc = 1.0 - ((py + jy) / height) * 2.0

    def m(base, r, c):
        return cam_ref[base + 4 * r + c]

    def unproject(z):
        # NDC (x, y, z) → view space through inv(proj) with w-divide, then
        # → world through the affine inv(view): row-vector p @ M + M[3]
        vx, vy, vz, vw = [x_ndc * m(0, 0, c) + y_ndc * m(0, 1, c)
                          + z * m(0, 2, c) + m(0, 3, c) for c in range(4)]
        vx, vy, vz = vx / vw, vy / vw, vz / vw
        return [vx * m(16, 0, c) + vy * m(16, 1, c) + vz * m(16, 2, c)
                + m(16, 3, c) for c in range(3)]

    ox, oy, oz = unproject(0.0)
    fx, fy, fz = unproject(1.0)
    dx, dy, dz = _normalize(fx - ox, fy - oy, fz - oz)

    sky_b = [scal_ref[1 + c] for c in range(3)]
    sky_t = [scal_ref[4 + c] for c in range(3)]

    def bounce(carry):
        b, ox, oy, oz, dx, dy, dz, cr, cg, cb, active = carry

        # ---- triangle sweep: Möller–Trumbore, closest t (`shape.cu:62-103`)
        def tri_body(j, best):
            bt, bi = best
            v0x, v0y, v0z = tri_ref[j, 0], tri_ref[j, 1], tri_ref[j, 2]
            e1x, e1y, e1z = tri_ref[j, 3], tri_ref[j, 4], tri_ref[j, 5]
            e2x, e2y, e2z = tri_ref[j, 6], tri_ref[j, 7], tri_ref[j, 8]
            pvx = dy * e2z - dz * e2y
            pvy = dz * e2x - dx * e2z
            pvz = dx * e2y - dy * e2x
            det = e1x * pvx + e1y * pvy + e1z * pvz
            inv_det = 1.0 / jnp.where(jnp.abs(det) < det_eps, 1.0, det)
            tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
            u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
            qvx = tvy * e1z - tvz * e1y
            qvy = tvz * e1x - tvx * e1z
            qvz = tvx * e1y - tvy * e1x
            v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
            t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
            ok = ((jnp.abs(det) >= det_eps) & (u >= 0.0) & (u <= 1.0)
                  & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min)
                  & (t <= t_max) & (tri_ref[j, 19] > 0.5))
            upd = ok & (t < bt)  # strict: ties keep the lowest index
            return jnp.where(upd, t, bt), jnp.where(upd, j, bi)

        tt = jnp.full((BLOCK,), _BIG, f32)
        ti = jnp.full((BLOCK,), -1, jnp.int32)
        if n_tri:
            tt, ti = jax.lax.fori_loop(0, n_tri, tri_body, (tt, ti))
        hit_tri = ti >= 0
        # spheres are bounded by the triangle hit (`path_tracer.cu:257-295`)
        t_cap = jnp.where(hit_tri, tt, t_max)

        # ---- sphere sweep (`shape.cu:13-46`, far-root quirk kept) ---------
        def sph_body(j, best):
            bt, bi = best
            ocx = sph_ref[j, 0] - ox
            ocy = sph_ref[j, 1] - oy
            ocz = sph_ref[j, 2] - oz
            r = sph_ref[j, 3]
            halfb = ocx * dx + ocy * dy + ocz * dz
            c = (ocx * ocx + ocy * ocy + ocz * ocz) - r * r
            delta = halfb * halfb - c
            sq = jnp.sqrt(jnp.where(delta > 0.0, delta, 1.0)) * (delta > 0.0)
            t_near = halfb - sq
            t = jnp.where(t_near >= t_min, t_near, halfb + sq)
            ok = ((delta >= 0.0) & (t_near <= t_cap) & (t >= t_min)
                  & (sph_ref[j, 5] > 0.5))
            upd = ok & (t < bt)
            return jnp.where(upd, t, bt), jnp.where(upd, j, bi)

        si = jnp.full((BLOCK,), -1, jnp.int32)
        if n_sph:
            _, si = jax.lax.fori_loop(
                0, n_sph, sph_body, (jnp.full((BLOCK,), _BIG, f32), si))
        use_sph = si >= 0
        hit = hit_tri | use_sph

        # ---- winner attributes from indexed loads (`closest_hit`) ---------
        ti0 = jnp.maximum(ti, 0)
        tcol = [plgpu.load(tri_ref.at[ti0, k]) for k in range(19)]
        v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = tcol[:9]
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv_det = 1.0 / jnp.where(det == 0.0, 1.0, det)
        tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
        u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t_tri = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        w_ = 1.0 - u - v
        tnx, tny, tnz = _normalize(
            w_ * tcol[9] + u * tcol[12] + v * tcol[15],
            w_ * tcol[10] + u * tcol[13] + v * tcol[16],
            w_ * tcol[11] + u * tcol[14] + v * tcol[17])
        gnx = e1y * e2z - e1z * e2y
        gny = e1z * e2x - e1x * e2z
        gnz = e1x * e2y - e1y * e2x
        t_front = dx * gnx + dy * gny + dz * gnz < 0.0
        tnx = jnp.where(t_front, tnx, -tnx)
        tny = jnp.where(t_front, tny, -tny)
        tnz = jnp.where(t_front, tnz, -tnz)

        si0 = jnp.maximum(si, 0)
        scx, scy, scz, sr, smat = [plgpu.load(sph_ref.at[si0, k])
                                   for k in range(5)]
        ocx, ocy, ocz = scx - ox, scy - oy, scz - oz
        halfb = dx * ocx + dy * ocy + dz * ocz
        c = (ocx * ocx + ocy * ocy + ocz * ocz) - sr * sr
        delta = halfb * halfb - c
        sq = jnp.sqrt(jnp.where(delta > 0.0, delta, 1.0)) * (delta > 0.0)
        t_near = halfb - sq
        t_sph = jnp.where(t_near >= t_min, t_near, halfb + sq)
        psx, psy, psz = ox + t_sph * dx, oy + t_sph * dy, oz + t_sph * dz
        r_safe = jnp.where(sr > 0.0, sr, 1.0)
        snx, sny, snz = (psx - scx) / r_safe, (psy - scy) / r_safe, \
            (psz - scz) / r_safe
        s_front = dx * snx + dy * sny + dz * snz < 0.0
        snx = jnp.where(s_front, snx, -snx)
        sny = jnp.where(s_front, sny, -sny)
        snz = jnp.where(s_front, snz, -snz)

        ptx, pty, ptz = ox + t_tri * dx, oy + t_tri * dy, oz + t_tri * dz
        hx = jnp.where(use_sph, psx, ptx)
        hy = jnp.where(use_sph, psy, pty)
        hz = jnp.where(use_sph, psz, ptz)
        nx = jnp.where(use_sph, snx, tnx)
        ny = jnp.where(use_sph, sny, tny)
        nz = jnp.where(use_sph, snz, tnz)
        mid = jnp.where(use_sph, smat, tcol[18]).astype(jnp.int32)
        kind, ar, ag, ab, param = [plgpu.load(mat_ref.at[mid, k])
                                   for k in range(_MAT_COLS)]

        # ---- scatter (`materials.scatter`, `material.cu:5-62`) ------------
        u1 = plgpu.load(ur_ref.at[2 * b, rows], mask=live, other=0.0)
        u2 = plgpu.load(ur_ref.at[2 * b + 1, rows], mask=live, other=0.0)
        # ONB rows u, v, w with w = normalize(n) (`onb.h:7-12`)
        len_sq = nx * nx + ny * ny + nz * nz
        rs = jnp.where(len_sq > 0.0,
                       jax.lax.rsqrt(jnp.where(len_sq > 0.0, len_sq, 1.0)),
                       0.0)
        wx, wy, wz = nx * rs, ny * rs, nz * rs
        big_x = jnp.abs(wx) > 0.9
        ax = jnp.where(big_x, 0.0, 1.0)
        ay = jnp.where(big_x, 1.0, 0.0)
        bvx, bvy, bvz = wy * 0.0 - wz * ay, wz * ax - wx * 0.0, \
            wx * ay - wy * ax
        v_len = jnp.sqrt(bvx * bvx + bvy * bvy + bvz * bvz)
        v_div = jnp.where(v_len > 0.0, v_len, 1.0)
        bvx, bvy, bvz = bvx / v_div, bvy / v_div, bvz / v_div
        bux = bvy * wz - bvz * wy
        buy = bvz * wx - bvx * wz
        buz = bvx * wy - bvy * wx
        # cosine-weighted local sample (`random.cu:96-107`)
        phi = _TAU * u1
        rad = jnp.sqrt(u2)
        lx, ly, lz = jnp.cos(phi) * rad, jnp.sin(phi) * rad, jnp.sqrt(1.0 - u2)
        wix = lx * bux + ly * bvx + lz * wx
        wiy = lx * buy + ly * bvy + lz * wy
        wiz = lx * buz + ly * bvz + lz * wz
        pdf = (nx * wix + ny * wiy + nz * wiz) / _PI
        degen = pdf < pdf_eps
        wix = jnp.where(degen, nx, wix)
        wiy = jnp.where(degen, ny, wiy)
        wiz = jnp.where(degen, nz, wiz)
        pdf = jnp.where(degen, 1.0 / _PI, pdf)
        cosw = jnp.maximum(0.0, nx * wix + ny * wiy + nz * wiz)

        # Oren–Nayar in planar-projection form (`materials.scatter`)
        sigma = jnp.clip(param, 0.0, 1.0)
        sigma2 = sigma * sigma
        coef_a = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
        coef_b = 0.45 * sigma2 / (sigma2 + 0.09)
        wox, woy, woz = -dx, -dy, -dz

        def planar_len(x, y):
            s = x * x + y * y
            return jnp.sqrt(jnp.where(s > 0.0, s, 1.0)) * (s > 0.0)

        li = planar_len(wix, wiy)
        lo = planar_len(wox, woy)
        li_div = jnp.where(li > 0, li, 1.0)
        lo_div = jnp.where(lo > 0, lo, 1.0)
        ci = jnp.where(li > 1e-12, wix / li_div, 1.0)
        s_i = jnp.where(li > 1e-12, wiy / li_div, 0.0)
        co = jnp.where(lo > 1e-12, wox / lo_div, 1.0)
        s_o = jnp.where(lo > 1e-12, woy / lo_div, 0.0)
        cos_dphi = ci * co + s_i * s_o
        cos_to = jnp.clip(wox * nx + woy * ny + woz * nz, 0.0, 1.0)
        cos_ti = jnp.clip(cosw, 0.0, 1.0)
        cos_a = jnp.minimum(cos_ti, cos_to)
        cos_b = jnp.maximum(cos_ti, cos_to)
        sin_a_sq = jnp.maximum(1.0 - cos_a * cos_a, 0.0)
        sin_a = jnp.sqrt(jnp.where(sin_a_sq > 0.0, sin_a_sq, 1.0)) * (
            sin_a_sq > 0.0)
        tan_b_sq = jnp.maximum(1.0 - cos_b * cos_b, 0.0)
        tan_b = jnp.sqrt(jnp.where(tan_b_sq > 0.0, tan_b_sq, 1.0)) * (
            tan_b_sq > 0.0) * (1.0 / jnp.maximum(cos_b, 1e-6))
        on = (coef_a + coef_b * cos_dphi * sin_a * tan_b) / _PI

        emissive = kind == 1.0
        pdf = jnp.where(emissive, 1.0, pdf)
        cosw = jnp.where(emissive, 1.0, cosw)
        ratio = cosw / pdf
        a_sky = (dy + 1.0) * 0.5
        factors = []
        for alb, lo_s, hi_s in ((ar, sky_b[0], sky_t[0]),
                                (ag, sky_b[1], sky_t[1]),
                                (ab, sky_b[2], sky_t[2])):
            att = jnp.where(emissive, param * alb, alb * on)
            sky = (1.0 - a_sky) * lo_s + a_sky * hi_s
            factors.append(jnp.where(hit, ratio * att, sky))
        cr = cr * jnp.where(active, factors[0], 1.0)
        cg = cg * jnp.where(active, factors[1], 1.0)
        cb = cb * jnp.where(active, factors[2], 1.0)

        nxt = active & hit & ~emissive
        ox = jnp.where(nxt, hx + shadow_eps * nx, ox)
        oy = jnp.where(nxt, hy + shadow_eps * ny, oy)
        oz = jnp.where(nxt, hz + shadow_eps * nz, oz)
        dx = jnp.where(nxt, wix, dx)
        dy = jnp.where(nxt, wiy, dy)
        dz = jnp.where(nxt, wiz, dz)
        return b + 1, ox, oy, oz, dx, dy, dz, cr, cg, cb, nxt

    def any_alive(carry):
        b, active = carry[0], carry[-1]
        return (b < max_depth) & (jnp.max(active.astype(jnp.int32)) > 0)

    ones = jnp.ones((BLOCK,), f32)
    carry = (jnp.int32(0), ox, oy, oz, dx, dy, dz, ones, ones, ones, live)
    carry = jax.lax.while_loop(any_alive, bounce, carry)
    color = carry[7:10]

    # ---- clamp + scrub + running average (`path_tracer.cu:345-358`) -----
    n1 = scal_ref[0]
    for c in range(3):
        col = color[c]
        if clamp:
            col = jnp.clip(col, 0.0, 1.0)
        col = jnp.where(jnp.isfinite(col), col, 0.0)
        old = plgpu.load(acc_in_ref.at[rows, c], mask=live, other=0.0)
        plgpu.store(acc_ref.at[rows, c], col / n1 + old * ((n1 - 1.0) / n1),
                    mask=live)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "n_tri", "n_sph", "max_depth", "clamp", "t_min",
    "t_max", "det_eps", "shadow_eps", "pdf_eps", "interpret"))
def _path_call(scal, camv, jitter, urand, tri, sph, mat, acc, *, width,
               height, n_tri, n_sph, max_depth, clamp, t_min, t_max, det_eps,
               shadow_eps, pdf_eps, interpret=False):
    n_rays = acc.shape[0]
    kernel = functools.partial(
        _path_kernel, n_rays=n_rays, width=width, height=height, n_tri=n_tri,
        n_sph=n_sph, max_depth=max_depth, clamp=clamp, t_min=t_min,
        t_max=t_max, det_eps=det_eps, shadow_eps=shadow_eps, pdf_eps=pdf_eps)
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n_rays, BLOCK),),
        out_shape=jax.ShapeDtypeStruct(acc.shape, acc.dtype),
        input_output_aliases={7: 0},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="path_sample",
    )(scal, camv, jitter, urand, tri, sph, mat, acc)


def accumulate(key, packet, cam, linear, frame, config, spp: int = 1,
               interpret: bool = False):
    """Trace ``spp`` progressive samples per pixel into the running average.

    The kernel route of `pathtracer.render_step`, with the same per-sample
    keys: sample s uses ``fold(fold(key, s), n1)`` with n1 = frame + s + 1.

    Args:
      key: the step's PRNG key.
      packet, cam, config: ScenePacket, Camera, RenderConfig.
      linear: (H*W, 3) running-average buffer, updated in place.
      frame: () int32 samples accumulated so far.
      spp: samples to add.
      interpret: run the kernel in the Pallas interpreter (tests only).
    Returns the updated (H*W, 3) buffer.
    """
    n_rays = cam.height * cam.width
    tri, sph, mat, nt, ns = pack_tables(packet)
    camv = camera_matrices(cam)
    sky = jnp.concatenate([packet.sky_bottom, packet.sky_top])

    def one_sample(s, lin):
        n1 = frame + s + 1
        skey = rng.fold(rng.fold(key, s), n1)
        jitter, urand = sample_uniforms(skey, n_rays, config.max_depth)
        scal = jnp.concatenate([
            n1.astype(jnp.float32).reshape(1), sky,
            jnp.zeros((1,), jnp.float32)]).astype(jnp.float32)
        return _path_call(
            scal, camv, jitter, urand, tri, sph, mat, lin,
            width=cam.width, height=cam.height, n_tri=nt, n_sph=ns,
            max_depth=config.max_depth, clamp=config.clamp_samples,
            t_min=config.t_min, t_max=config.t_max, det_eps=config.det_eps,
            shadow_eps=config.shadow_eps, pdf_eps=config.pdf_eps,
            interpret=interpret)

    return jax.lax.fori_loop(0, spp, one_sample, linear)
