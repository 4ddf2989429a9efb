"""Single-device differentiable training steps at BASELINE scale.

The BASELINE headline asks for forward+backward at 1080p / 64 spp
(reference config 4: the mixed analytic + ~16k-triangle scene). Two exact
schedules for the image-MSE loss  L = mean((M - T)^2),  M = (1/S) sum_s I_s:

* `mse_step` — the monolithic sample-level-remat'd `lax.scan` (one
  `value_and_grad` dispatch). Exact, and the simplest schedule when one
  sample's backward residuals fit device memory alongside the scan state.

* `two_pass_mse_step` — the O(one-sample) constant-memory schedule for
  scenes whose per-sample residuals are too large for the scan:

      pass 1:  M = (1/S) sum_s I_s(theta)            (forward only)
      cot    = dL/dI_s = 2 (M - T) / (N * S)         (same for every s)
      pass 2:  dL/dtheta = sum_s cot . dI_s/dtheta   (one fixed-cotangent
                                                      vjp per sample)

  This is the EXACT gradient — dM/dI_s = 1/S is sample-independent, so the
  cotangent factors out of the sum — validated against `mse_step` to float
  precision (`tests/test_train_step.py`). Both passes run on the device as
  `lax.scan`s over chunks of ``samples_per_call`` samples.

Every trace here takes the staged XLA route (`integrator.trace`): it is the
differentiable one.

Reference: the reference has no training loop at all (no gradients anywhere
in `IoniqRE/`); this module exists for BASELINE configs 4-5's
differentiable-rendering requirement. Multi-device training is
`parallel.sharding.shard_train_step`, which shards rows/samples over the
mesh; this module is the single-device building block.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ptre.ops import camera as cam_ops, gradsafe, rng
from ptre.parallel import sharding as sh
from ptre.render import pathtracer as pt
from ptre.utils.config import RenderConfig


def sample_color(params, packet, cam, config: RenderConfig, key):
    """One jittered sample per pixel → RAW linear color (H*W, 3), row-major.

    The differentiable-parameter pytree (`sharding.differentiable_params`)
    overrides the packet/camera leaves; colors are unclamped (training
    integrates in linear space — clamping belongs to display, and would
    zero gradients at saturation).
    """
    pk, cm = sh._apply_params(params, packet, cam)
    px, py = pt.pixel_grid(cm.height, cm.width)
    jitter = rng.pixel_jitter(rng.fold(key, 0x9E37), (px.shape[0],))
    o, d = cam_ops.get_rays(cm, px, py, jitter)
    from ptre.ops import integrator

    return integrator.trace(key, o, d, pk, config)


@functools.partial(jax.jit, static_argnames=("config", "spp"))
def mse_step(params, packet, cam, target, key, config: RenderConfig,
             spp: int = 1):
    """Monolithic (loss, grads) of the image MSE at ``spp`` samples.

    Sample-level remat (`jax.checkpoint` around the scan body) keeps ONE
    sample's backward residuals live at a time; `spp == 1` skips the scan
    entirely (a length-1 grad-of-scan materializes every body intermediate
    as a while-loop residual). ``target``: (H*W, 3) linear, row-major.
    """

    def loss_fn(par, k):
        def body(acc, s):
            return acc + sample_color(par, packet, cam, config,
                                      rng.fold(k, s)), None

        if spp == 1:
            acc, _ = body(jnp.zeros_like(target), 0)
            return jnp.mean((acc - target) ** 2)
        acc, _ = jax.lax.scan(
            jax.checkpoint(body, policy=gradsafe.remat_policy),
            jnp.zeros_like(target), jnp.arange(spp))
        return jnp.mean((acc / spp - target) ** 2)

    return jax.value_and_grad(loss_fn)(params, key)


@functools.partial(jax.jit, static_argnames=("config", "spp"))
def _fwd_scan(params, packet, cam, key, s0, config: RenderConfig, spp: int):
    """On-device sum of ``spp`` sample images for sample ids s0..s0+spp-1."""
    def body(acc, s):
        return acc + sample_color(params, packet, cam, config,
                                  rng.fold(key, s0 + s)), None

    z = jnp.zeros((config.height * config.width, 3), jnp.float32)
    acc, _ = jax.lax.scan(body, z, jnp.arange(spp))
    return acc


@functools.partial(jax.jit, static_argnames=("config", "spp"))
def _vjp_scan(params, packet, cam, key, cot, s0, config: RenderConfig,
              spp: int):
    """On-device sum of fixed-cotangent sample vjps for ids s0..s0+spp-1."""
    def body(g, s):
        gs = jax.grad(lambda par: jnp.vdot(
            sample_color(par, packet, cam, config, rng.fold(key, s0 + s)),
            cot))(params)
        return jax.tree.map(jnp.add, g, gs), None

    g0 = jax.tree.map(jnp.zeros_like, params)
    g, _ = jax.lax.scan(body, g0, jnp.arange(spp))
    return g


def two_pass_mse_step(params, packet, cam, target, key,
                      config: RenderConfig, spp: int = 64,
                      samples_per_call: int = 8):
    """Exact (loss, grads) of the image MSE with O(one-sample) memory.

    An on-device forward scan for the mean image, then an on-device vjp
    scan with the fixed cotangent 2(M - T)/(N*S) (module docstring). Use
    when the monolithic remat'd scan's per-sample residuals exceed chip
    memory (config 4 at 1080p/64spp).

    ``samples_per_call`` bounds how many samples one device program scans,
    so that no single dispatch of a large scene runs for minutes; each
    chunk is one dispatch per pass. The chunk split does not change the
    math (the scans accumulate the same sums).
    """
    n = target.size
    c = max(1, min(samples_per_call, spp))
    assert spp % c == 0, (spp, c)

    acc = None
    for s0 in range(0, spp, c):
        part = _fwd_scan(params, packet, cam, key, s0, config, c)
        acc = part if acc is None else acc + part
    mean_img = acc / spp
    loss = jnp.mean((mean_img - target) ** 2)
    cot = jax.lax.stop_gradient(2.0 * (mean_img - target) / (n * spp))

    grads = None
    for s0 in range(0, spp, c):
        g = _vjp_scan(params, packet, cam, key, cot, s0, config, c)
        grads = g if grads is None else jax.tree.map(jnp.add, grads, g)
    return loss, grads
