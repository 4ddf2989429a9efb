"""BSDF tests vs closed-form values (`material.cu`)."""

import jax.numpy as jnp
import numpy as np

from ptre.ops import materials as mat
from ptre.ops import rng
from ptre.ops.vecmat import pi


def _scatter(n_rays=4096, kind=mat.KIND_OREN_NAYAR, albedo=(0.5, 0.5, 0.5),
             param=1.0, normal=(0.0, 1.0, 0.0), d_in=(0.0, -1.0, 0.0), seed=7):
    R = n_rays
    key = rng.key_for(seed)
    d = jnp.tile(jnp.asarray(d_in, jnp.float32)[None], (R, 1))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    p = jnp.zeros((R, 3))
    n = jnp.tile(jnp.asarray(normal, jnp.float32)[None], (R, 1))
    kinds = jnp.full((R,), kind, jnp.int32)
    alb = jnp.tile(jnp.asarray(albedo, jnp.float32)[None], (R, 1))
    par = jnp.full((R,), param, jnp.float32)
    return mat.scatter(key, d, p, n, kinds, alb, par)


def test_oren_nayar_sampling_distribution():
    s = _scatter()
    wi = np.asarray(s.next_dir)
    # all scattered into upper hemisphere
    assert wi[:, 1].min() >= 0.0
    # cosine-weighted: E[cos] = 2/3
    np.testing.assert_allclose(wi[:, 1].mean(), 2 / 3, atol=0.02)
    # pdf = n·wi / pi (`material.cu:45-48`)
    np.testing.assert_allclose(np.asarray(s.pdf), wi[:, 1] / pi, atol=1e-5)
    # cos_weight = max(0, n·wi)
    np.testing.assert_allclose(np.asarray(s.cos_weight), wi[:, 1], atol=1e-6)
    # origin offset along normal by 1e-4 (`material.cu:11`)
    np.testing.assert_allclose(np.asarray(s.next_origin)[:, 1], 1e-4, atol=1e-7)
    assert not np.any(np.asarray(s.terminated))


def test_oren_nayar_sigma0_is_lambert():
    # sigma = 0 → A = 1, B = 0 → f = albedo/pi regardless of angles
    s = _scatter(param=0.0, albedo=(0.8, 0.6, 0.4))
    np.testing.assert_allclose(
        np.asarray(s.attenuation),
        np.tile([[0.8, 0.6, 0.4]], (s.attenuation.shape[0], 1)) / pi,
        atol=1e-5,
    )


def test_oren_nayar_ab_terms():
    # closed-form A/B for sigma = 1 (`material.cu:22-24`), sigma clamped [0,1]
    sigma2 = 1.0
    A = 1.0 - 0.5 * sigma2 / (sigma2 + 0.33)
    B = 0.45 * sigma2 / (sigma2 + 0.09)
    s = _scatter(param=5.0)  # clamps to 1 (`material.h:25-30`)
    wi = np.asarray(s.next_dir)
    wo = np.array([0.0, 1.0, 0.0])  # d_in = -y → wo = +y = normal
    # theta_o = 0 → beta could be 0 or theta_i; since wo == n, theta_o = 0 → tan(beta)=tan(0 or min)=... beta=min(theta_i,0)=0
    # → coeff = A exactly
    expect = 0.5 * A / pi
    np.testing.assert_allclose(np.asarray(s.attenuation)[:, 0], expect, atol=3e-4)


def test_oren_nayar_reciprocity_of_coeff():
    # swapping wi/wo leaves the A/B coeff invariant (alpha/beta symmetric);
    # here we just check attenuation is finite and positive for grazing wo
    s = _scatter(d_in=(1.0, -0.02, 0.0))
    att = np.asarray(s.attenuation)
    assert np.all(np.isfinite(att))


def test_emissive_terminates_with_strength_times_color():
    s = _scatter(kind=mat.KIND_EMISSIVE, albedo=(1.0, 0.9, 0.8), param=10.0)
    assert np.all(np.asarray(s.terminated))
    np.testing.assert_allclose(
        np.asarray(s.attenuation), np.tile([[10.0, 9.0, 8.0]], (4096, 1)), atol=1e-5
    )
    np.testing.assert_allclose(np.asarray(s.pdf), 1.0)
    np.testing.assert_allclose(np.asarray(s.cos_weight), 1.0)


def test_sky_gradient():
    d = jnp.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0], [0.0, 0.0, 1.0]])
    sky = mat.sky_attenuation(d, (1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
    np.testing.assert_allclose(sky[0], [0.5, 0.7, 1.0], atol=1e-6)  # up → top
    np.testing.assert_allclose(sky[1], [1.0, 1.0, 1.0], atol=1e-6)  # down → bottom
    np.testing.assert_allclose(sky[2], [0.75, 0.85, 1.0], atol=1e-6)  # horizon mix


def test_degenerate_pdf_fallback():
    # force the degenerate branch by zeroing the sample: can't directly, but
    # verify the fallback invariants hold over many draws — pdf never below
    # the eps floor once fallback applies (`material.cu:15-18`)
    s = _scatter(n_rays=65536, seed=11)
    pdf = np.asarray(s.pdf)
    wi = np.asarray(s.next_dir)
    degen = pdf < 1e-5
    if degen.any():
        np.testing.assert_allclose(pdf[degen], 1 / pi)
        np.testing.assert_allclose(wi[degen], [0.0, 1.0, 0.0], atol=1e-6)


def test_scatter_is_differentiable():
    import jax

    def f(albedo):
        s = _scatter(n_rays=64)
        # re-run with traced albedo
        key = rng.key_for(7)
        d = jnp.tile(jnp.array([[0.0, -1.0, 0.0]]), (64, 1))
        n = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (64, 1))
        rec = mat.scatter(
            key, d, jnp.zeros((64, 3)), n,
            jnp.zeros((64,), jnp.int32), jnp.tile(albedo[None], (64, 1)),
            jnp.full((64,), 0.7),
        )
        return jnp.sum(rec.attenuation)

    g = jax.grad(f)(jnp.array([0.5, 0.5, 0.5]))
    assert np.all(np.isfinite(np.asarray(g)))
    assert np.all(np.asarray(g) > 0)
