"""Counter-based, splittable RNG + sampling distributions.

Replaces the reference's stateful per-pixel curand state array
(`IoniqRE/random.{h,cu}`, seeded at `path_tracer.cu:36-46` with seed 1984 and
sequence = pixel id) with JAX's counter-based threefry PRNG: keys are derived
functionally from (seed, frame, pixel, bounce, draw) so every sample is
reproducible, order-independent, and shardable across chips with no state.

The distribution helpers mirror the reference device functions exactly
(`random.cu:66-107`): uniform reals in [min, max), uniform directions on the
unit sphere / hemisphere, and the concentric sqrt cosine-weighted hemisphere
sample in a local z-up frame.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ptre.ops.vecmat import pi, tau

#: default seed, mirroring `curand_init(1984, pixelid, 0, ...)` (`path_tracer.cu:45`)
DEFAULT_SEED = 1984


def key_for(seed) -> jax.Array:
    """Root PRNG key from an integer seed."""
    return jax.random.PRNGKey(seed)


def fold(key: jax.Array, *ids) -> jax.Array:
    """Derive a subkey by folding in integer identifiers (frame, bounce, ...)."""
    for i in ids:
        key = jax.random.fold_in(key, i)
    return key


def uniform(key, shape=(), minval=0.0, maxval=1.0, dtype=jnp.float32):
    """Uniform reals in [minval, maxval) (reference `random.cu:66-70`)."""
    return jax.random.uniform(key, shape, dtype, minval, maxval)


def uint(key, shape=(), minval=0, maxval=2**31 - 1):
    """Uniform integers in [minval, maxval] inclusive (reference
    `random.cu:10-20` host/device `random::uint`)."""
    return jax.random.randint(key, shape, minval, maxval + 1, jnp.uint32)


def pixel_jitter(key, shape):
    """Sub-pixel jitter in [-0.5, 0.5) per pixel, 2 components (`camera.cu:24-25`)."""
    return jax.random.uniform(key, shape + (2,), jnp.float32, -0.5, 0.5)


def on_unit_sphere(key, shape=()):
    """Uniform direction on the unit sphere (reference `random.cu:72-84`).

    z = cos(theta) uniform in [-1, 1], azimuth phi uniform in [0, tau).
    """
    k1, k2 = jax.random.split(key)
    phi = jax.random.uniform(k1, shape, jnp.float32, 0.0, tau)
    z = jax.random.uniform(k2, shape, jnp.float32, -1.0, 1.0)
    sin_theta = jnp.sqrt(1.0 - z * z)
    return jnp.stack([sin_theta * jnp.cos(phi), sin_theta * jnp.sin(phi), z], axis=-1)


def on_unit_hemisphere(key, normal):
    """Uniform direction on the hemisphere around ``normal`` (`random.cu:86-94`)."""
    d = on_unit_sphere(key, normal.shape[:-1])
    flip = jnp.sum(d * normal, axis=-1, keepdims=True) > 0.0
    return jnp.where(flip, d, -d)


def cosine_weighted(key, shape=()):
    """Cosine-weighted hemisphere sample, local z-up (reference `random.cu:96-107`).

    phi = tau*u1; (x, y) = (cos phi, sin phi) * sqrt(u2); z = sqrt(1 - u2).
    """
    k1, k2 = jax.random.split(key)
    u1 = jax.random.uniform(k1, shape, jnp.float32)
    u2 = jax.random.uniform(k2, shape, jnp.float32)
    phi = tau * u1
    r = jnp.sqrt(u2)
    return jnp.stack([jnp.cos(phi) * r, jnp.sin(phi) * r, jnp.sqrt(1.0 - u2)], axis=-1)


def onb_from_normal(n):
    """Orthonormal basis {u, v, w} with w = normalize(n) (reference `onb.h:7-12`).

    Branches on |w.x| > 0.9 for a stable cross product, exactly like the
    reference; returned as a (..., 3, 3) matrix whose ROWS are (u, v, w), so a
    local z-up sample maps to world as ``local @ basis``
    (`onb.h:18-21` transform_to_world).
    """
    len_sq = jnp.sum(n * n, axis=-1, keepdims=True)
    w = n * jnp.where(len_sq > 0, jax.lax.rsqrt(jnp.where(len_sq > 0, len_sq, 1.0)), 0.0)
    from ptre.ops import gradsafe

    a = jnp.where(
        gradsafe.remat_pin(jnp.abs(w[..., 0]) > 0.9)[..., None],
        jnp.array([0.0, 1.0, 0.0], jnp.float32),
        jnp.array([1.0, 0.0, 0.0], jnp.float32),
    )
    v = jnp.cross(w, a)
    # double-where: a zero normal (w = 0) must not give sqrt(0)'s infinite
    # derivative to the backward pass
    v_sq = jnp.sum(v * v, axis=-1, keepdims=True)
    v = v / jnp.where(v_sq > 0, jnp.sqrt(jnp.where(v_sq > 0, v_sq, 1.0)), 1.0)
    u = jnp.cross(v, w)
    return jnp.stack([u, v, w], axis=-2)
