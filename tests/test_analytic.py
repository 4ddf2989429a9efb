"""Closed-form analytic radiance tests + progressive-variance law.

These go beyond self-generated goldens (which only detect *change*, not
*systematic wrongness*): each test pins the integrator against a value
derivable on paper from the reference's integrator contract
(`path_tracer.cu:231-328`, `material.cu:5-62`).
"""

import jax
import jax.numpy as jnp
import numpy as np

from ptre.models import demo, mesh as mg
from ptre.models.scene import Material, MaterialKind, Model, Scene
from ptre.ops import camera as cam_ops, integrator, rng
from ptre.render import pathtracer as pt
from ptre.utils.config import RenderConfig


def test_lambertian_sphere_under_sky_depth1_analytic():
    """Head-on Lambertian (σ=0) sphere under the gradient sky.

    Path: hit → cosine-scatter → sky. Per-sample radiance is
    albedo ⊙ sky(wi); over cosine-weighted wi about the normal n,
    E[wi] = (2/3)n, so with n = (0,0,-1) (head-on hit) E[wi.y] = 0 and

        E[L] = albedo ⊙ (sky_bottom + sky_top) / 2.

    A systematic error in the cosine sampling, the pdf, the Oren-Nayar A
    term, or the sky lerp shifts this mean.
    """
    scn = Scene()
    scn.add_mesh("s", mg.uv_sphere(False, 8, 4))  # SPHERES type: analytic
    scn.add_model("m", Model("s", material=None))
    scn.get_model("m").set_transforms(1.0, 0.0, (0.0, 0.5, 0.0))
    # σ=0: pure Lambertian (A=1, B=0)
    scn._materials[0] = Material(MaterialKind.OREN_NAYAR, (0.5, 0.5, 0.5), 0.0)
    pkt = scn.build_packet()
    cfg = RenderConfig(width=2, height=2, max_depth=2, clamp_samples=False)

    o = jnp.array([[0.0, 0.5, -3.0]], jnp.float32)
    d = jnp.array([[0.0, 0.0, 1.0]], jnp.float32)

    N = 4096
    keys = jax.vmap(lambda i: rng.fold(rng.key_for(0), i))(jnp.arange(N))
    colors = jax.jit(
        jax.vmap(lambda k: integrator.trace(k, o, d, pkt, cfg)[0])
    )(keys)
    mean = np.asarray(jnp.mean(colors, axis=0))

    albedo = np.array([0.5, 0.5, 0.5])
    expected = albedo * (np.array(cfg.sky_bottom) + np.array(cfg.sky_top)) / 2
    # se ≈ per-sample std (~0.1-0.3) / sqrt(4096) ≈ 0.005 per channel
    np.testing.assert_allclose(mean, expected, atol=0.02)


def test_lambertian_floor_under_emissive_dome_exact():
    """Every cosine-scattered ray from a Lambertian floor hits a huge
    emissive ceiling quad → each SAMPLE equals albedo ⊙ strength·color
    EXACTLY (factor (cos/pdf)·(albedo/π) = albedo; terminal emissive
    contributes strength·color; zero variance). Pins MT intersection of
    secondary rays + terminal-emissive semantics deterministically.
    """
    scn = Scene()
    scn.add_mesh("q", mg.quad())
    scn.add_model("floor", Model("q", material=0))
    # quad() spans the xy-plane; rotate -π/2 about x → horizontal at y=0
    scn.get_model("floor").set_transforms(
        50.0, (-np.pi / 2, 0.0, 0.0), (0.0, 0.0, 0.0))
    scn.add_model("ceil", Model("q", material=1))
    scn.get_model("ceil").set_transforms(
        500.0, (np.pi / 2, 0.0, 0.0), (0.0, 2.0, 0.0))
    scn._materials[0] = Material(MaterialKind.OREN_NAYAR, (0.25, 0.5, 0.75), 0.0)
    scn._materials[1] = Material(MaterialKind.EMISSIVE, (1.0, 0.8, 0.6), 10.0)
    pkt = scn.build_packet()
    cfg = RenderConfig(width=2, height=2, max_depth=3, clamp_samples=False)

    # straight-down rays from above the floor
    o = jnp.tile(jnp.array([[0.3, 1.0, 0.1]], jnp.float32), (4, 1))
    o = o + jnp.array([[0.0, 0.0, 0.0], [0.1, 0.0, 0.2],
                       [-0.2, 0.0, 0.1], [0.05, 0.0, -0.3]], jnp.float32)
    d = jnp.tile(jnp.array([[0.0, -1.0, 0.0]], jnp.float32), (4, 1))

    expected = np.array([0.25, 0.5, 0.75]) * 10.0 * np.array([1.0, 0.8, 0.6])
    for seed in (0, 1, 2):
        c = np.asarray(integrator.trace(rng.key_for(seed), o, d, pkt, cfg))
        np.testing.assert_allclose(c, expected[None, :].repeat(4, 0),
                                   rtol=2e-5, atol=1e-5)


def test_progressive_variance_scales_inverse_n():
    """Var of the running-average accumulator after n samples ∝ 1/n
    (`path_tracer.cu:356-358`): the n=4 accumulator's pixel variance across
    independent runs must be ≈ 1/4 of the n=1 variance."""
    scn = demo.reference_demo_scene(8, 4)
    pkt = scn.build_packet()
    H = W = 8
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)

    K = 48

    def run(key, spp):
        accum = pt.AccumState.create(H, W)
        return pt.render_step(pkt, cam, accum, key, cfg, spp=spp).linear

    run_j = jax.jit(run, static_argnums=1)
    keys = [rng.fold(rng.key_for(123), i) for i in range(K)]
    r1 = np.stack([np.asarray(run_j(k, 1)) for k in keys])  # (K, H, W, 3)
    r4 = np.stack([np.asarray(run_j(k, 4)) for k in keys])

    v1 = r1.var(axis=0)
    v4 = r4.var(axis=0)
    # restrict to genuinely noisy pixels to keep the ratio well-conditioned
    mask = v1 > 1e-4
    assert mask.sum() > 20
    ratio = (v1[mask] / np.maximum(v4[mask], 1e-12)).mean()
    # K=48 runs → wide CI; the law predicts 4.0
    assert 2.5 < ratio < 6.0, ratio
