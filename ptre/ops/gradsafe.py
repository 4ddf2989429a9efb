"""Forward-exact, gradient-stabilized forms for the differentiable chain's
near-singular terms.

An earlier measurement of remat and geometry-gradient conditioning found
that rematerialization moves individual GEOMETRY gradient entries
by 10-40 % while material/sky gradients hold to 0.1 %: remat recompiles the
forward in a different fusion context, and the chain's near-singular
curvature terms amplify the resulting last-ulp residual differences into
percent-level gradient differences. The three named amplifiers:

  * ``1 / det``            (Moller-Trumbore, edge-on triangles)
  * ``1 / (2 sqrt(delta))``  (sphere root, tangent/silhouette rays)
  * ``tan_b = sin_b / max(cos_b, 1e-6)``  (Oren-Nayar, grazing incidence)

Each is unbounded on a measure-zero set the detached-visibility estimator
already treats as non-differentiable (the hit SELECTION is detached there
too), so rays within O(tau) of the singular set carry astronomically
high-variance gradient samples — pure noise to SGD, and the entire
remat-instability budget.

Two complementary mechanisms live here (the round-5 bisection separated
them — see `tests/test_grad_conditioning.py`):

1. **Heavy-tail clamps** — the straight-through pattern

       stable + stop_gradient(forward - stable)

   keeps the VALUE bit-identical to the reference formula (golden images
   and forward parity untouched) while routing the GRADIENT through a
   tau-floored denominator: exact wherever the denominator clears ``tau``,
   zero inside the tau-neighborhood of the singularity (gradient clipping
   at the source — standard for detached estimators, and a variance
   reduction for SGD). These bound the TRUE gradient tails; measured
   alone they did NOT fix remat instability.

2. **Remat pins** (`remat_pin` + `remat_policy`) — what actually fixes
   remat: under `jax.checkpoint` the backward re-linearizes the chain at
   an ulp-shifted recompute point, and the heavy-tailed Jacobians turn
   that into percent-level gradient movement (`everything_saveable`
   agreed to 1e-8; any recompute diverged 7-40 %). Pinning the O(R)
   ray-geometry floats (primary rays, hit t/p/n, scatter direction, world
   triangles) and every discrete branch decision as SAVED residuals makes
   every recomputed sub-chain re-linearize from bit-equal inputs, while
   the memory-dominant O(R*P) sweep still rematerializes. Measured:
   config-2 geometry gradients remat-vs-plain 24-43 % -> 1.2-2.9 %
   per-leaf norm-relative; materials/sky 3e-3 -> 1e-4.

The differentiable chain — `ops.intersect` (hit attributes) and
`ops.materials` (shading) — applies these forms; the forward-only path
kernel (`ops.pallas.path_kernel`) uses the plain values they equal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: gradient-path floor for the Oren-Nayar 1/cos_b (cos of ~87 deg):
#: bounds the tan_b amplification at 1/tau^2 = 400x instead of 1e12x
TAU_COS = 0.05
#: relative gradient-path floor for |det| (vs |e1||e2|, |d| = 1): edge-on
#: beyond ~89.94 deg carries zero geometry gradient
TAU_DET = 1e-3
#: relative gradient-path floor for the sphere discriminant (vs r^2):
#: bounds d t/d radius near silhouettes at ~1/sqrt(tau) = 100x
TAU_DELTA = 1e-4


def value_with_stable_grad(forward, stable):
    """VALUE of ``forward``, GRADIENT of ``stable`` (straight-through)."""
    return stable + jax.lax.stop_gradient(forward - stable)


#: residual name for discrete branch decisions (see `remat_pin`)
_PIN = "ptre_branch_pin"

#: `jax.checkpoint` policy for every remat site in the renderer: SAVE the
#: pinned discrete branch decisions, recompute everything else. Curvature
#: clamps alone do not make remat'd gradients stable — the round-5
#: measurement localized the instability to BRANCH FLIPS: the
#: rematerialized forward recompiles in a different fusion context, its
#: recomputed floats differ in the last ulp, and a handful of silhouette /
#: grazing / degenerate-pdf rays flip their `where` branch between forward
#:  and backward, swapping those rays' gradient contributions wholesale.
#: Pinning the masks (a few bool/int32 (R,) arrays per bounce — noise next
#: to the O(R*P) sweep the policy still recomputes) makes the backward
#: walk exactly the forward's branches.
remat_policy = jax.checkpoint_policies.save_only_these_names(_PIN)


def remat_pin(x):
    """Mark a discrete branch decision (mask / selection index) as a SAVED
    residual under `remat_policy`. Identity outside `jax.checkpoint`."""
    from jax.ad_checkpoint import checkpoint_name

    return checkpoint_name(x, _PIN)


def cosine_ratio(cosw, pdf):
    """`cos_weight / pdf` with its EXACT analytic gradient (= zero).

    For the cosine-weighted hemisphere BSDF the ratio is IDENTICALLY a
    constant in every branch: pdf = (n.wi)/pi with cos_weight = n.wi
    (regular), and pdf = 1/pi with cos_weight = 1 (degenerate fallback),
    so cos_weight/pdf === pi; the emissive branch sets both to 1. The
    value is still computed as the reference's float division
    (`path_tracer.cu:320-326` parity), but the autodiff'd backward
    evaluates (pdf d cosw - cosw d pdf)/pdf^2 — a cancellation XLA happens
    to resolve exactly today (the round-5 A/B measured bit-identical
    gradients with and without the detach), but whose exactness depends on
    CSE producing identical roundings for both product terms; any fusion
    change would turn it into roundoff amplified by 1/pdf^2 (up to 1e10 at
    the pdf_eps boundary). Detaching the ratio IS the exact derivative of
    the mathematical quantity, independent of compiler behavior.
    """
    return jax.lax.stop_gradient(cosw / pdf)


def stable_recip_cos(cos_b):
    """1 / max(cos_b, 1e-6) in value; gradient floored at TAU_COS."""
    fwd = 1.0 / jnp.maximum(cos_b, 1e-6)
    stable = 1.0 / jnp.maximum(cos_b, TAU_COS)
    return value_with_stable_grad(fwd, stable)


def stable_inv_det(det, e1_sq, e2_sq):
    """1 / det (det==0 -> 1/1) in value; gradient floored at
    TAU_DET * |e1| * |e2| (the max possible |det| for unit d)."""
    floor = jax.lax.stop_gradient(
        TAU_DET * jnp.sqrt(jnp.maximum(e1_sq * e2_sq, 1e-24)))
    sign = jnp.where(det < 0.0, -1.0, 1.0)
    fwd = 1.0 / jnp.where(det == 0.0, 1.0, det)
    stable = sign / jnp.maximum(jnp.abs(det), floor)
    return value_with_stable_grad(fwd, stable)


def stable_sqrt_delta(delta, radius):
    """Double-where-guarded sqrt(delta) in value; gradient floored at
    TAU_DELTA * r^2 (zero gradient for rays inside the silhouette band)."""
    floor = jax.lax.stop_gradient(
        TAU_DELTA * (radius * radius) + 1e-24)
    fwd = jnp.sqrt(jnp.where(delta > 0.0, delta, 1.0)) * (delta > 0.0)
    stable = jnp.sqrt(jnp.maximum(delta, floor)) * (delta > 0.0)
    return value_with_stable_grad(fwd, stable)
