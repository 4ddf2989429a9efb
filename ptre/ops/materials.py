"""Differentiable BSDF / material evaluation.

JAX equivalent of `IoniqRE/material.{h,cu}` + `IoniqRE/onb.h`: the
virtual `material::scatter` dispatch becomes masked branchless evaluation over
a material table (kind, albedo, param) gathered per ray — `lax.switch`-free
since both kinds are cheap and `jnp.where` keeps lanes full.

Semantics preserved exactly:
  * oren_nayar (`material.cu:5-43`): ONB cosine-weighted hemisphere sample;
    scattered origin offset p + 1e-4 n; pdf = n·wi/π with the degenerate-pdf
    fallback (pdf < 1e-5 → cast along the normal with pdf = 1/π,
    `material.cu:15-18`); cos_law_weight = max(0, n·wi); full A/B term with
    WORLD-space azimuthal angles atan2(w.y, w.x) — faithfully reproducing the
    reference's frame choice; sigma clamped to [0,1] (`material.h:25-30`);
    attenuation = albedo * coeff / π.
  * emissive (`material.cu:50-62`): terminal; attenuation = strength * color,
    pdf = cos_law_weight = 1. Emission is modeled as a terminal multiplicative
    "attenuation", not added radiance — the reference's integrator contract
    (`path_tracer.cu:297-305,320-326`).
"""

from __future__ import annotations

import jax.numpy as jnp

from ptre.ops import gradsafe, rng
from ptre.ops import vecmat as vm
from ptre.ops.vecmat import pi
from ptre.utils import pytree

KIND_OREN_NAYAR = 0
KIND_EMISSIVE = 1


@pytree.dataclass
class ScatterRecord:
    """Vectorized scatter_record (reference `material.h:7-12`) + next ray."""

    attenuation: jnp.ndarray  # (R, 3)
    pdf: jnp.ndarray  # (R,)
    cos_weight: jnp.ndarray  # (R,)
    next_origin: jnp.ndarray  # (R, 3)
    next_dir: jnp.ndarray  # (R, 3)
    terminated: jnp.ndarray  # (R,) bool — emissive ends the path


def scatter(
    key,
    d_in,
    hit_p,
    hit_n,
    mat_kind,
    mat_albedo,
    mat_param,
    shadow_eps: float = 1e-4,
    pdf_eps: float = 1e-5,
) -> ScatterRecord:
    """Evaluate scatter for every ray's hit material, branchlessly.

    Args:
      key: PRNG key for this bounce (array draws differ per ray).
      d_in: (R, 3) incoming ray unit directions.
      hit_p, hit_n: (R, 3) hit position and (unit, front-facing) normal.
      mat_kind: (R,) int32 material kinds gathered from the table.
      mat_albedo: (R, 3); mat_param: (R,) sigma or strength.
    """
    R = d_in.shape[0]
    wo = -d_in

    # --- oren_nayar sampling (`material.cu:7-18`) -------------------------
    basis = rng.onb_from_normal(hit_n)  # (R, 3, 3) rows u, v, w
    local = rng.cosine_weighted(key, (R,))  # (R, 3) z-up
    wi = vm.einsum("rk,rkj->rj", local, basis)

    pdf = vm.einsum("rk,rk->r", hit_n, wi) / pi
    # pinned branch decision (remat-stable backward, ops/gradsafe.py)
    degen = gradsafe.remat_pin(pdf < pdf_eps)
    # the scatter direction is pinned as a float residual for the same
    # linearization-point stability (ops/gradsafe.py); everything derived
    # from (pinned n, pinned wi) recomputes bit-stably
    wi = gradsafe.remat_pin(jnp.where(degen[:, None], hit_n, wi))
    pdf = jnp.where(degen, 1.0 / pi, pdf)
    cos_weight = jnp.maximum(0.0, vm.einsum("rk,rk->r", hit_n, wi))

    # --- oren_nayar BRDF value (`material.cu:20-41`) ----------------------
    # Planar-projection form of the reference's azimuthal/polar angles:
    # cos(phi_i - phi_o) from xy-plane projections instead of atan2, and
    # sin(alpha)/tan(beta) from the cosines instead of arccos/sin/tan —
    # mathematically identical for the physical inputs (the reference's phi
    # are world-space atan2(w.y, w.x), same frame), transcendental-light,
    # and, critically, gradient-safe: atan2(0, 0) has a NaN derivative,
    # and rays scattered exactly along +-z (cube-face normals via the
    # degenerate-pdf fallback) HIT that pole at 1080p x 64spp scale
    # (found by tests/test_scale_1080p.py). The path kernel
    # (`ops/pallas/path_kernel.py`) evaluates the same formula.
    sigma = jnp.clip(mat_param, 0.0, 1.0)
    sigma2 = sigma * sigma
    A = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
    B = 0.45 * sigma2 / (sigma2 + 0.09)

    li_sq = wi[:, 0] ** 2 + wi[:, 1] ** 2
    li = jnp.sqrt(jnp.where(li_sq > 0.0, li_sq, 1.0)) * (li_sq > 0.0)
    lo_sq = wo[:, 0] ** 2 + wo[:, 1] ** 2
    lo = jnp.sqrt(jnp.where(lo_sq > 0.0, lo_sq, 1.0)) * (lo_sq > 0.0)
    ci = jnp.where(li > 1e-12, wi[:, 0] / jnp.where(li > 0, li, 1.0), 1.0)
    si = jnp.where(li > 1e-12, wi[:, 1] / jnp.where(li > 0, li, 1.0), 0.0)
    co = jnp.where(lo > 1e-12, wo[:, 0] / jnp.where(lo > 0, lo, 1.0), 1.0)
    so = jnp.where(lo > 1e-12, wo[:, 1] / jnp.where(lo > 0, lo, 1.0), 0.0)
    cos_dphi = ci * co + si * so
    cos_to = jnp.clip(vm.einsum("rk,rk->r", wo, hit_n), 0.0, 1.0)
    cos_ti = jnp.clip(cos_weight, 0.0, 1.0)
    # alpha = max(theta_i, theta_o) -> cos_alpha = min(cos_i, cos_o)
    cos_a = jnp.minimum(cos_ti, cos_to)
    cos_b = jnp.maximum(cos_ti, cos_to)
    sin_a_sq = jnp.maximum(1.0 - cos_a * cos_a, 0.0)
    sin_a = jnp.sqrt(jnp.where(sin_a_sq > 0.0, sin_a_sq, 1.0)) * (
        sin_a_sq > 0.0)
    tan_b_sq = jnp.maximum(1.0 - cos_b * cos_b, 0.0)
    # value = the reference sin_b / max(cos_b, 1e-6); gradient floored at
    # grazing incidence (gradsafe: remat-stable gradients)
    tan_b = jnp.sqrt(jnp.where(tan_b_sq > 0.0, tan_b_sq, 1.0)) * (
        tan_b_sq > 0.0) * gradsafe.stable_recip_cos(cos_b)

    coeff = A + B * cos_dphi * sin_a * tan_b
    on_attenuation = mat_albedo * (coeff / pi)[:, None]

    # --- emissive (`material.cu:50-57`) -----------------------------------
    em_attenuation = mat_param[:, None] * mat_albedo

    is_emissive = mat_kind == KIND_EMISSIVE
    attenuation = jnp.where(is_emissive[:, None], em_attenuation, on_attenuation)
    pdf = jnp.where(is_emissive, 1.0, pdf)
    cos_weight = jnp.where(is_emissive, 1.0, cos_weight)

    next_origin = hit_p + shadow_eps * hit_n
    return ScatterRecord(
        attenuation=attenuation,
        pdf=pdf,
        cos_weight=cos_weight,
        next_origin=next_origin,
        next_dir=wi,
        terminated=is_emissive,
    )


def emitted(mat_kind, mat_albedo, mat_param):
    """Emitted radiance per material row (reference `material.cu:59-62`):
    strength * color for EMISSIVE, zero otherwise."""
    e = mat_param[..., None] * mat_albedo
    return jnp.where((mat_kind == KIND_EMISSIVE)[..., None], e, 0.0)


def sky_attenuation(d, sky_bottom, sky_top):
    """Miss shading: vertical gradient (`path_tracer.cu:307-316`).

    a = (dir.y + 1)/2; attenuation = (1-a)*bottom + a*top; pdf = weight = 1.
    """
    a = (d[:, 1] + 1.0) * 0.5
    bottom = jnp.asarray(sky_bottom, jnp.float32)
    top = jnp.asarray(sky_top, jnp.float32)
    return (1.0 - a)[:, None] * bottom + a[:, None] * top
