"""ptre — a JAX differentiable path tracer + rasterizer framework.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of IoniqRE
(GionutN/path-tracer-and-rasterizer-engine): two swappable rendering engines
over one scene graph —

1. a progressive path tracer (analytic sphere intersection, Möller–Trumbore
   triangles, Oren–Nayar + emissive materials, ONB cosine sampling,
   counter-based PRNG, running-average accumulation), and
2. a z-buffered triangle rasterizer (supersampled MSAA-style resolve,
   back-face culling, ambient+diffuse shading),

both implemented as pure, jit-compiled, differentiable functions over an
HBM-resident SoA scene, shardable over a `jax.sharding.Mesh`.

Layout:
  ops/      — math, RNG, camera, intersection, BSDFs, integrator, Pallas kernels
  models/   — meshes, scene graph, scene packet, demo scenes
  render/   — path tracer + rasterizer frame pipelines, engine facade
  parallel/ — device-mesh sharding of pixel tiles / ray batches
  utils/    — config, image IO, checkpointing, metrics, errors
"""

__version__ = "0.1.0"

from ptre.utils import config as config  # noqa: F401
