"""Batched ray–primitive intersection (branchless, whole-array).

JAX equivalent of `IoniqRE/shape.{h,cu}`: the reference's virtual
`shape::intersect` dispatch and per-thread sequential closest-hit loop
(`path_tracer.cu:252-295`) become masked, vectorized candidate evaluation over
(R rays × P primitives) followed by an argmin reduction — no data-dependent
control flow, so XLA fuses the candidate math into the reduction.

Semantics preserved from the reference:
  * Sphere (`shape.cu:13-46`): half-b quadratic with unit ray direction
    (a = 1); the near root is rejected if beyond t_max, and if the near root
    is below t_min the FAR root is accepted with only a t_min check (the
    reference never re-checks t_max on the far root — preserved).
  * Triangle Möller–Trumbore (`shape.cu:62-103`): no back-face culling,
    |det| < 1e-6 rejection, u/v barycentric rejection, smooth normal
    (1-u-v)n0 + u n1 + v n2 normalized, front-face flip from the geometric
    normal sign.
  * Triangles are tested before spheres, and an accepted sphere replaces an
    equal-t triangle hit (`path_tracer.cu:257-295` iteration order). Ties
    within a primitive class resolve to the lowest index (the reference's
    last-wins-on-exact-tie is measure-zero under float arithmetic).

The two-pass structure (cheap t-only sweep + argmin, then full shading
attributes recomputed for the single best primitive per ray) keeps the (R, P)
intermediate to one array so XLA fuses it into the reduction instead of
spilling to HBM.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptre.ops import vecmat as vm
from ptre.utils import pytree

_BIG = 1e30


@pytree.dataclass
class HitRecord:
    """Vectorized hit_record (reference `shape.h:7-14`)."""

    t: jnp.ndarray  # (R,)
    position: jnp.ndarray  # (R, 3)
    normal: jnp.ndarray  # (R, 3) — flipped to face the ray (front_face logic)
    front_face: jnp.ndarray  # (R,) bool
    mat_id: jnp.ndarray  # (R,) int32
    hit: jnp.ndarray  # (R,) bool


def _sphere_candidates(o, d, center, radius, valid, t_min, t_max):
    """Per-(ray, sphere) candidate t. Shapes: o,d (R,3); center (S,3).

    Returns (t, accepted): (R, S) each. `t_max` may be (R,) or scalar.
    """
    oc = center[None, :, :] - o[:, None, :]  # (R, S, 3)
    halfb = vm.einsum("rsk,rk->rs", oc, d)
    c = jnp.sum(oc * oc, axis=-1) - (radius * radius)[None, :]
    delta = halfb * halfb - c
    # sqrt has an infinite derivative at 0: keep the argument strictly
    # positive on the (masked-out) miss lanes so gradients stay finite
    sq = jnp.sqrt(jnp.where(delta > 0.0, delta, 1.0)) * (delta > 0.0)
    t_near = halfb - sq
    t_far = halfb + sq
    t = jnp.where(t_near >= t_min, t_near, t_far)
    t_max = jnp.broadcast_to(jnp.asarray(t_max)[..., None], t_near.shape)
    accepted = (
        (delta >= 0.0)
        & (t_near <= t_max)  # near-root-only t_max check (`shape.cu:26-28`)
        & (t >= t_min)
        & valid[None, :]
    )
    return t, accepted


def intersect_spheres(o, d, center, radius, valid, t_min, t_max):
    """Closest accepted sphere per ray → (t, index, hit): (R,), (R,), (R,)."""
    t, accepted = _sphere_candidates(o, d, center, radius, valid, t_min, t_max)
    t_masked = jnp.where(accepted, t, _BIG)
    idx = jnp.argmin(t_masked, axis=-1)
    best_t = jnp.min(t_masked, axis=-1)  # == t_masked[idx]; no (R, P) gather
    hit = jnp.any(accepted, axis=-1)
    return jnp.where(hit, best_t, _BIG), idx, hit


def sphere_hit_attrs(o, d, t, center, radius):
    """Shading attributes for one sphere hit per ray (`shape.cu:39-45`)."""
    p = o + t[:, None] * d
    n = (p - center) / radius[:, None]
    front = jnp.sum(d * n, axis=-1) < 0.0
    n = jnp.where(front[:, None], n, -n)
    return p, n, front


def _mt_t(o, d, v0, e1, e2, t_min, t_max, det_eps):
    """Möller–Trumbore t-only sweep over (R rays × T tris) → (t, accepted)."""
    # pvec = d × e2 : (R, T, 3)
    pvec = jnp.cross(d[:, None, :], e2[None, :, :])
    det = vm.einsum("tk,rtk->rt", e1, pvec)
    inv_det = 1.0 / jnp.where(jnp.abs(det) < det_eps, 1.0, det)
    tvec = o[:, None, :] - v0[None, :, :]  # (R, T, 3)
    u = vm.einsum("rtk,rtk->rt", tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = vm.einsum("rk,rtk->rt", d, qvec) * inv_det
    t = vm.einsum("tk,rtk->rt", e2, qvec) * inv_det
    t_max = jnp.broadcast_to(jnp.asarray(t_max)[..., None], t.shape)
    accepted = (
        (jnp.abs(det) >= det_eps)
        & (u >= 0.0)
        & (u <= 1.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
        & (t >= t_min)
        & (t <= t_max)
    )
    return t, accepted


def _plane_edges_t(o, d, v0, v1, v2, eps):
    """Alternate triangle test: plane + inside/outside edge tests.

    Port of the reference's `#else` branch (`shape.cu:104-148`, compiled out
    by default via MOLLER_TRUMBORE=1 at `shape.cu:4`) — kept for algorithm
    parity and as an independent cross-check of Möller–Trumbore. Note the
    reference's quirks are preserved: t is only rejected when negative (no
    t_min/t_max) in the branch itself; callers apply the range.
    """
    e1 = v1 - v0
    e2 = v2 - v0
    e12 = v2 - v1
    normal = jnp.cross(e1, e2)
    ndotd = vm.einsum("rk,tk->rt", d, normal)
    denom = jnp.where(jnp.abs(ndotd) < eps, 1.0, ndotd)
    dist = -vm.einsum("tk,tk->t", normal, v0)
    t = -(vm.einsum("rk,tk->rt", o, normal) + dist[None, :]) / denom

    p = o[:, None, :] + t[..., None] * d[:, None, :]  # (R, T, 3)

    def outside(a, edge):
        ep = p - a[None, :, :]
        n2 = jnp.cross(jnp.broadcast_to(edge[None], ep.shape), ep)
        return vm.einsum("rtk,tk->rt", n2, normal) < 0.0

    inside = (
        ~outside(v0, e1) & ~outside(v1, e12)
        & (vm.einsum("rtk,tk->rt", jnp.cross(p - v0[None], jnp.broadcast_to(e2[None], p.shape)), normal) >= 0.0)
    )
    accepted = (jnp.abs(ndotd) >= eps) & (t >= 0.0) & inside
    return t, accepted


def intersect_triangles_plane_edges(o, d, v0, v1, v2, valid, t_min, t_max, eps=1e-6):
    """Closest triangle via the plane/edge-test path (`shape.cu:104-148`)."""
    t, accepted = _plane_edges_t(o, d, v0, v1, v2, eps)
    accepted = accepted & valid[None, :] & (t >= t_min) & (t <= jnp.asarray(t_max)[..., None])
    t_masked = jnp.where(accepted, t, _BIG)
    idx = jnp.argmin(t_masked, axis=-1)
    best_t = jnp.min(t_masked, axis=-1)  # == t_masked[idx]; no (R, P) gather
    hit = jnp.any(accepted, axis=-1)
    return jnp.where(hit, best_t, _BIG), idx, hit


def intersect_triangles(o, d, v0, v1, v2, valid, t_min, t_max, det_eps=1e-6):
    """Closest accepted triangle per ray → (t, index, hit).

    v0/v1/v2 are WORLD-space (T, 3) — pre-transformed once per frame by
    `ScenePacket.world_triangles`, not per ray per bounce like the reference
    (`path_tracer.cu:265-270`); images are identical, cost is O(T) not O(R*T*B).
    """
    e1 = v1 - v0
    e2 = v2 - v0
    t, accepted = _mt_t(o, d, v0, e1, e2, t_min, t_max, det_eps)
    accepted = accepted & valid[None, :]
    t_masked = jnp.where(accepted, t, _BIG)
    idx = jnp.argmin(t_masked, axis=-1)
    best_t = jnp.min(t_masked, axis=-1)  # == t_masked[idx]; no (R, P) gather
    hit = jnp.any(accepted, axis=-1)
    return jnp.where(hit, best_t, _BIG), idx, hit


def triangle_hit_attrs(o, d, t, v0, v1, v2, n0, n1, n2):
    """Recompute u/v + smooth normal for the single best triangle per ray.

    All triangle inputs are per-ray gathers of shape (R, 3). Matches the
    normal interpolation + front-face flip at `shape.cu:96-101`.
    """
    t_re, p, n, front = triangle_hit_attrs_t(o, d, v0, v1, v2, n0, n1, n2)
    del t_re
    p = o + t[:, None] * d
    return p, n, front


def triangle_hit_attrs_t(o, d, v0, v1, v2, n0, n1, n2):
    """Differentiable recompute of (t, p, n, front) for one triangle per ray.

    Used after the detached sweep selects the best primitive: re-deriving t
    from the gathered triangle keeps gradients w.r.t. geometry flowing
    through an O(R) computation instead of the O(R*T) sweep.
    """
    from ptre.ops import gradsafe

    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(d, e2)
    det = vm.einsum("rk,rk->r", e1, pvec)
    # value = the reference 1/det; gradient floored near edge-on
    # (gradsafe: remat-stable geometry gradients)
    inv_det = gradsafe.stable_inv_det(
        det, jnp.sum(e1 * e1, axis=-1), jnp.sum(e2 * e2, axis=-1))
    tvec = o - v0
    u = vm.einsum("rk,rk->r", tvec, pvec) * inv_det
    qvec = jnp.cross(tvec, e1)
    v = vm.einsum("rk,rk->r", d, qvec) * inv_det
    t = vm.einsum("rk,rk->r", e2, qvec) * inv_det

    n = (1.0 - u - v)[:, None] * n0 + u[:, None] * n1 + v[:, None] * n2
    n = vm.normalize(n)
    geo_n = jnp.cross(e1, e2)
    front = gradsafe.remat_pin(vm.einsum("rk,rk->r", d, geo_n) < 0.0)
    n = jnp.where(front[:, None], n, -n)
    p = o + t[:, None] * d
    return t, p, n, front


def sphere_hit_attrs_t(o, d, center, radius, t_min):
    """Differentiable recompute of (t, p, n, front) for one sphere per ray.

    Replays the near/far root rule of `shape.cu:13-46` on the single gathered
    sphere so dt/d(center, radius) exists.
    """
    from ptre.ops import gradsafe

    oc = center - o
    halfb = vm.einsum("rk,rk->r", d, oc)
    c = jnp.sum(oc * oc, axis=-1) - radius * radius
    delta = halfb * halfb - c
    # value = the double-where-guarded root; gradient floored near the
    # silhouette (gradsafe: remat-stable geometry gradients)
    sq = gradsafe.stable_sqrt_delta(delta, radius)
    t_near = halfb - sq
    near_ok = gradsafe.remat_pin(t_near >= t_min)
    t = jnp.where(near_ok, t_near, halfb + sq)
    p = o + t[:, None] * d
    # radius==0 rows occur when the unified replay table gathers a triangle
    # row through the sphere-attr path (the result is where'd out, but an
    # unguarded 1/0 would poison gradients through the select)
    r_safe = jnp.where(radius > 0.0, radius, 1.0)
    n = (p - center) / r_safe[:, None]
    front = gradsafe.remat_pin(vm.einsum("rk,rk->r", d, n) < 0.0)
    n = jnp.where(front[:, None], n, -n)
    return t, p, n, front


def sweep(o, d, packet, world_tris, t_min, t_max, det_eps=1e-6):
    """Brute-force closest-hit SWEEP: per-ray best primitive (detached).

    Returns (i_tri, hit_tri, i_sph, hit_sph) — integer/boolean selection only;
    the differentiable attributes are recomputed from the gathers in
    `closest_hit`.
    """
    v0, v1, v2, _, _, _ = world_tris
    t_tri, i_tri, hit_tri = intersect_triangles(
        o, d, v0, v1, v2, packet.tri_valid, t_min, t_max, det_eps
    )
    # spheres are tested against the triangle-shrunk t_max, and an accepted
    # sphere (incl. the far-root quirk) replaces the triangle hit
    _, i_sph, hit_sph = intersect_spheres(
        o, d, packet.sph_center, packet.sph_radius, packet.sph_valid,
        t_min, jnp.where(hit_tri, t_tri, t_max),
    )
    return i_tri, hit_tri, i_sph, hit_sph


def closest_hit(o, d, packet, world_tris, t_min, t_max, det_eps=1e-6
                ) -> HitRecord:
    """Scene closest-hit: triangles first, then spheres (`path_tracer.cu:252-295`).

    Two-phase structure: a DETACHED O(R*P) selection sweep (stop-gradient —
    discrete visibility is treated as locally constant, the standard
    detached-sampling estimator), then a differentiable O(R) recompute of
    (t, position, normal) from the selected primitive's gathered data. The
    backward pass therefore never stores the sweep.

    Args:
      o, d: (R, 3) ray origins / unit directions.
      packet: ScenePacket (for sphere arrays, material ids, masks).
      world_tris: (v0, v1, v2, n0, n1, n2) world-space from
        `packet.world_triangles()` — hoisted out so the bounce scan reuses it.
    """
    v0, v1, v2, n0, n1, n2 = world_tris

    from ptre.ops import gradsafe

    sg = jax.lax.stop_gradient
    i_tri, hit_tri, i_sph, hit_sph = sweep(
        sg(o), sg(d), jax.tree.map(sg, packet), jax.tree.map(sg, world_tris),
        t_min, t_max, det_eps,
    )
    # pin the detached selection as a SAVED remat residual: under
    # `jax.checkpoint(..., policy=gradsafe.remat_policy)` the backward must
    # re-shade exactly the primitives the forward chose — an ulp-level
    # recompute difference must not flip a silhouette ray to a different
    # winner (the round-5 remat-instability mechanism, ops/gradsafe.py)
    i_tri, hit_tri, i_sph, hit_sph = map(
        gradsafe.remat_pin, (i_tri, hit_tri, i_sph, hit_sph))

    use_sph = hit_sph
    hit = hit_tri | hit_sph

    # differentiable recompute on the selected primitive only; ONE packed
    # (R, 18) gather instead of six (R, 3) gathers
    tri_packed = jnp.concatenate([v0, v1, v2, n0, n1, n2], axis=1)  # (T, 18)
    gt = tri_packed[i_tri]  # (R, 18)
    g0, g1, g2 = gt[:, 0:3], gt[:, 3:6], gt[:, 6:9]
    # rays that do not take the triangle's attributes (sphere winners and
    # misses, whose gathered triangle is just row 0) recompute them on a
    # benign stand-in ray instead: from the gathered triangle's centroid
    # along its unit geometric normal. A ray nearly parallel to the
    # triangle's plane would give u, v ~ 1e7 and a normal that cancels to
    # zero; the value is discarded, but its NaN/inf partials would still
    # poison the backward pass (0 * NaN = NaN).
    tri_used = (hit_tri & ~use_sph)[:, None]
    sg_n = sg(vm.normalize(jnp.cross(g1 - g0, g2 - g0)))
    o_t = jnp.where(tri_used, o, sg((g0 + g1 + g2) / 3.0) + sg_n)
    d_t = jnp.where(tri_used, d, -sg_n)
    t_tri, p_tri, n_tri, f_tri = triangle_hit_attrs_t(
        o_t, d_t, g0, g1, g2, gt[:, 9:12], gt[:, 12:15], gt[:, 15:18],
    )
    sph_packed = jnp.concatenate(
        [packet.sph_center, packet.sph_radius[:, None]], axis=1
    )  # (S, 4)
    gs = sph_packed[i_sph]
    t_sph, p_sph, n_sph, f_sph = sphere_hit_attrs_t(
        o, d, gs[:, 0:3], gs[:, 3], t_min
    )

    sel = use_sph[:, None]
    t = jnp.where(use_sph, t_sph, jnp.where(hit_tri, t_tri, _BIG))
    position = jnp.where(sel, p_sph, p_tri)
    normal = jnp.where(sel, n_sph, n_tri)
    front = jnp.where(use_sph, f_sph, f_tri)
    mat_id = jnp.where(use_sph, packet.sph_mat[i_sph], packet.tri_mat[i_tri])

    # pin the FLOAT hit state too (not just the selections): under remat
    # the backward otherwise re-linearizes the heavy-tailed attr Jacobians
    # at an ulp-shifted recompute point, which measurably moves geometry
    # gradients (round-5 bisection: everything_saveable agreed to 1e-8,
    # any recompute diverged % -level; see ops/gradsafe.py). Saving
    # (t, p, n) is O(R) floats per bounce -- noise next to the O(R*P)
    # sweep the policy still recomputes.
    return HitRecord(
        t=gradsafe.remat_pin(t), position=gradsafe.remat_pin(position),
        normal=gradsafe.remat_pin(normal), front_face=front,
        mat_id=mat_id, hit=hit,
    )
