"""Path-tracing integrator: fixed-depth masked bounce scan.

Array-program equivalent of `ray_color` (`IoniqRE/path_tracer.cu:231-328`):
the reference's per-thread iterative loop with a fixed scatter_record stack
and early break becomes a `lax.scan` over bounces carrying (ray, running
product, active mask) — a whole-array program has no per-ray control flow,
so terminated rays are masked entries whose product multiplier is 1.

The integrator contract (base formula Lo = Li * bsdf * (n·wi) / pdf, folded
multiplicatively over the stack at `path_tracer.cu:320-326`) is preserved:

  * per bounce, the contribution factor is cos_weight / pdf * attenuation;
  * an emissive hit terminates the path, its strength*color entering as the
    final multiplicative factor (`path_tracer.cu:297-305`);
  * a miss terminates with the sky gradient factor (`path_tracer.cu:307-316`);
  * a path still alive after max_depth bounces contributes just the product of
    its scatter factors (no sky/emission term) — exactly the reference's
    stack-exhaustion behavior.

Gradients flow through hit geometry, materials, transforms and camera; the
discrete hit selection (argmin index, hit/termination masks) is naturally
piecewise-constant so `jax.grad` treats it as locally constant — the standard
detached-sampling estimator for path-traced derivatives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptre.ops import gradsafe, materials, rng
from ptre.ops.intersect import closest_hit
from ptre.utils.config import RenderConfig


def trace(key, origins, directions, packet, config: RenderConfig):
    """Trace one sample per ray → linear color (R, 3).

    This is the staged XLA route: the differentiable path on every
    platform, and the plain reference the path kernel
    (`ops.pallas.path_kernel`) is checked against.

    Args:
      key: per-(frame, sample) PRNG key; bounce keys are folded from it.
      origins, directions: (R, 3) primary rays (unit directions).
      packet: ScenePacket.
      config: RenderConfig (max_depth, t range, sky, epsilons).
    """
    world_tris = packet.world_triangles()  # hoisted: shared across bounces

    def bounce(carry, b):
        o, d, color, active = carry
        hit = closest_hit(
            o, d, packet, world_tris, config.t_min, config.t_max, config.det_eps,
        )

        bkey = rng.fold(key, b)
        srec = materials.scatter(
            bkey,
            d,
            hit.position,
            hit.normal,
            packet.mat_kind[hit.mat_id],
            packet.mat_albedo[hit.mat_id],
            packet.mat_param[hit.mat_id],
            config.shadow_eps,
            config.pdf_eps,
        )

        sky = materials.sky_attenuation(d, packet.sky_bottom, packet.sky_top)

        # factor for this bounce: scatter term on hit, sky on miss
        # the cos/pdf ratio is analytically constant — detached value is
        # its exact gradient AND the dominant remat-noise fix (gradsafe)
        hit_factor = gradsafe.cosine_ratio(
            srec.cos_weight, srec.pdf)[:, None] * srec.attenuation
        factor = jnp.where(hit.hit[:, None], hit_factor, sky)
        color = color * jnp.where(active[:, None], factor, 1.0)

        terminated = ~hit.hit | srec.terminated
        next_active = active & ~terminated
        o = jnp.where(next_active[:, None], srec.next_origin, o)
        d = jnp.where(next_active[:, None], srec.next_dir, d)
        return (o, d, color, next_active), None

    if config.remat_bounces:
        # Backward-pass memory: without remat the scan saves every per-bounce
        # intermediate (hit records, ONB, scatter dirs — ~20 (R, 3) arrays x
        # max_depth, 2.5 GB per sample at 1080p). Checkpointing the body
        # keeps only the (o, d, color, active) carry per bounce and recomputes
        # the rest during backward — the "re-intersect instead of storing
        # hits" strategy (SURVEY §7), at ~2x bounce FLOPs.
        bounce = jax.checkpoint(bounce, policy=gradsafe.remat_policy)

    R = origins.shape[0]
    init = (
        origins,
        directions,
        jnp.ones((R, 3), jnp.float32),
        jnp.ones((R,), bool),
    )
    (_, _, color, _), _ = jax.lax.scan(
        bounce, init, jnp.arange(config.max_depth), length=config.max_depth
    )
    return color


def postprocess_sample(color, clamp: bool = True):
    """Per-sample clamp to [0,1] + non-finite scrub (`path_tracer.cu:345-353`).

    The reference clamps BEFORE accumulation (biasing bright emissive paths —
    preserved for parity) and then scrubs NaNs; its scrub ran after the
    accumulation add and was therefore ineffective — here the scrub is applied
    effectively (a conscious fix; with finite math NaNs should not occur).

    The scrub zeroes every non-finite value in BOTH modes: in the unbiased
    (``clamp=False``) HDR mode an ``inf`` sample must not enter the running
    average — ``nan_to_num``'s default would substitute float32-max (3.4e38),
    a finite-but-absurd value that silently poisons the accumulator forever.
    Dropping the sample (zero) keeps the estimator usable; with finite math
    the branch never fires.
    """
    if clamp:
        color = jnp.clip(color, 0.0, 1.0)
    return jnp.nan_to_num(color, nan=0.0, posinf=0.0, neginf=0.0)
