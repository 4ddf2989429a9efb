"""Progressive path-tracer frame pipeline.

JAX equivalent of the reference path tracer engine
(`IoniqRE/path_tracer.{h,cu}`): the 0.1 s sync → D2H copy → packet rebuild →
kernel relaunch dance (`path_tracer.cu:368-404`) becomes a single jit-compiled
`render_step` that takes the HBM-resident ScenePacket + accumulation state and
returns the updated state — the host touches pixels only to write files.
Buffer donation gives in-place accumulation; dispatch-ahead replaces the
reference's async-kernel overlap.

Accumulation reproduces `render_kernel` (`path_tracer.cu:330-366`) exactly:
one sample per pixel per "launch", per-sample clamp to [0,1], running average
lin = c/n + lin*(n-1)/n, and sqrt display gamma with truncating uint8 cast.
Reset keeps the reference's trick of only zeroing the sample counter — the
n = 1 running-average step overwrites history (`path_tracer.cu:394-400`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ptre.ops import camera as cam_ops
from ptre.ops import integrator, rng
from ptre.ops.pallas import path_kernel
from ptre.utils import pytree
from ptre.utils.config import RenderConfig


@pytree.dataclass
class AccumState:
    """Progressive accumulation state (reference `path_tracer.h:61-62`)."""

    linear: jnp.ndarray  # (H, W, 3) float32 running-average linear color
    frame: jnp.ndarray  # () int32 — samples accumulated so far (m_crt_frame)

    @classmethod
    def create(cls, height: int, width: int) -> "AccumState":
        return cls(
            linear=jnp.zeros((height, width, 3), jnp.float32),
            frame=jnp.zeros((), jnp.int32),
        )

    def reset(self) -> "AccumState":
        """Restart accumulation by zeroing the counter (`path_tracer.cu:394-400`);
        the linear buffer is overwritten at n=1 by the running average."""
        return self.replace(frame=jnp.zeros((), jnp.int32))


def pixel_grid(height: int, width: int):
    """Flattened pixel coordinates: x right, y down (pixelid = y*W + x)."""
    py, px = jnp.meshgrid(
        jnp.arange(height, dtype=jnp.float32),
        jnp.arange(width, dtype=jnp.float32),
        indexing="ij",
    )
    return px.reshape(-1), py.reshape(-1)


def uses_path_kernel() -> bool:
    """The forward route rule: the Triton path kernel
    (`ops.pallas.path_kernel`) on a GPU, the staged XLA route elsewhere.

    Every packet, camera and config goes to the kernel on a GPU: its
    primitive loops have no table-size limit. The kernel is forward-only;
    differentiable traces always take the staged route
    (`integrator.trace`). The platform is the default device's
    (``jax.default_device``) when one is set, else the default backend's.
    """
    dev = jax.config.jax_default_device
    platform = getattr(dev, "platform", dev) or jax.default_backend()
    return platform in ("gpu", "cuda")


def sample_image(key, packet, cam, config: RenderConfig, ray_chunk: int = 0):
    """One jittered sample per pixel → clamped linear color (H*W, 3).

    ``ray_chunk`` > 0 traces pixels in chunks of that size via `lax.map` to
    bound the (rays × primitives) intermediate; 0 traces all rays at once.
    """
    px, py = pixel_grid(cam.height, cam.width)
    jitter = rng.pixel_jitter(rng.fold(key, 0x9E37), (px.shape[0],))
    origins, dirs = cam_ops.get_rays(cam, px, py, jitter)

    if ray_chunk and px.shape[0] > ray_chunk:
        n = px.shape[0]
        assert n % ray_chunk == 0, (n, ray_chunk)
        chunks = n // ray_chunk
        o = origins.reshape(chunks, ray_chunk, 3)
        d = dirs.reshape(chunks, ray_chunk, 3)
        ids = jnp.arange(chunks)

        def one(args):
            cid, oc, dc = args
            return integrator.trace(rng.fold(key, cid), oc, dc, packet, config)

        color = jax.lax.map(one, (ids, o, d)).reshape(n, 3)
    else:
        color = integrator.trace(key, origins, dirs, packet, config)

    return integrator.postprocess_sample(color, config.clamp_samples)


def staged_render_step(packet, cam, accum: AccumState, key,
                       config: RenderConfig, spp: int = 1,
                       ray_chunk: int = 0) -> AccumState:
    """`render_step` through the staged XLA route on any platform: the
    plain reference the path kernel is checked against."""

    def body(carry, s):
        lin, n = carry
        n1 = n + 1
        skey = rng.fold(rng.fold(key, s), n1)
        img = sample_image(skey, packet, cam, config, ray_chunk)
        img = img.reshape(cam.height, cam.width, 3)
        n1f = n1.astype(jnp.float32)
        lin = img / n1f + lin * ((n1f - 1.0) / n1f)
        return (lin, n1), None

    (linear, frame), _ = jax.lax.scan(
        body, (accum.linear, accum.frame), jnp.arange(spp)
    )
    return AccumState(linear=linear, frame=frame)


def render_step(packet, cam, accum: AccumState, key, config: RenderConfig,
                spp: int = 1, ray_chunk: int = 0) -> AccumState:
    """Accumulate ``spp`` progressive samples into the running average.

    Each sample replays the reference's per-launch update with n = frame+1
    (`path_tracer.cu:356-358`, counter increment at `path_tracer.cu:401`).
    The route follows `uses_path_kernel`; both routes draw the same random
    numbers. ``ray_chunk`` bounds the staged route's (rays × primitives)
    intermediate and does not apply to the kernel, which has none.
    """
    if uses_path_kernel():
        H, W = cam.height, cam.width
        linear = path_kernel.accumulate(
            key, packet, cam, accum.linear.reshape(H * W, 3), accum.frame,
            config, spp)
        return AccumState(linear=linear.reshape(H, W, 3),
                          frame=accum.frame + spp)
    return staged_render_step(packet, cam, accum, key, config, spp, ray_chunk)


@functools.partial(jax.jit, static_argnames=("config", "spp", "ray_chunk"),
                   donate_argnames=("accum",))
def render_step_jit(packet, cam, accum, key, config, spp=1, ray_chunk=0):
    """Jitted render_step with accumulation-buffer donation (in-place update)."""
    return render_step(packet, cam, accum, key, config, spp, ray_chunk)


def to_display(linear, sqrt_gamma: bool = True):
    """Linear → display uint8 RGB: sqrt gamma, ×255, truncating cast
    (`path_tracer.cu:360-365`)."""
    img = jnp.sqrt(jnp.maximum(linear, 0.0)) if sqrt_gamma else linear
    return (255.0 * jnp.clip(img, 0.0, 1.0)).astype(jnp.uint8)


def to_bgra8(rgb_u8):
    """RGB uint8 → BGRA8 bytes, the reference framebuffer format
    (`path_tracer.h:15-21`, BGRA swap-chain `renderer_base.cu:44`)."""
    b = rgb_u8[..., 2:3]
    g = rgb_u8[..., 1:2]
    r = rgb_u8[..., 0:1]
    a = jnp.full_like(r, 255)
    return jnp.concatenate([b, g, r, a], axis=-1)
