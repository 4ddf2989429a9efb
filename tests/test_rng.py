"""RNG distribution tests (distributional, not bit-exact — curand sequences
cannot be matched; see SURVEY §7 'RNG parity')."""

import jax
import jax.numpy as jnp
import numpy as np

from ptre.ops import rng


def test_uniform_range_and_determinism():
    key = rng.key_for(rng.DEFAULT_SEED)
    u = rng.uniform(key, (10000,), minval=-0.5, maxval=0.5)
    assert float(u.min()) >= -0.5 and float(u.max()) < 0.5
    np.testing.assert_allclose(float(u.mean()), 0.0, atol=0.02)
    u2 = rng.uniform(key, (10000,), minval=-0.5, maxval=0.5)
    np.testing.assert_array_equal(u, u2)  # counter-based: same key → same draws


def test_fold_decorrelates():
    key = rng.key_for(0)
    a = rng.uniform(rng.fold(key, 1), (1000,))
    b = rng.uniform(rng.fold(key, 2), (1000,))
    assert abs(float(jnp.corrcoef(a, b)[0, 1])) < 0.1


def test_on_unit_sphere():
    d = rng.on_unit_sphere(rng.key_for(3), (20000,))
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    # uniform: each component mean 0, z uniform in [-1,1] → var 1/3
    np.testing.assert_allclose(np.mean(np.asarray(d), axis=0), 0.0, atol=0.02)
    np.testing.assert_allclose(np.var(np.asarray(d)[:, 2]), 1 / 3, atol=0.01)


def test_on_unit_hemisphere():
    n = jnp.tile(jnp.array([[0.0, 1.0, 0.0]]), (5000, 1))
    d = rng.on_unit_hemisphere(rng.key_for(4), n)
    assert float(jnp.min(jnp.sum(d * n, axis=-1))) > 0.0


def test_cosine_weighted():
    s = rng.cosine_weighted(rng.key_for(5), (40000,))
    z = np.asarray(s[:, 2])
    assert z.min() >= 0.0
    np.testing.assert_allclose(np.linalg.norm(np.asarray(s), axis=-1), 1.0, atol=1e-5)
    # E[cos theta] = 2/3 for pdf = cos/pi
    np.testing.assert_allclose(z.mean(), 2 / 3, atol=0.01)


def test_onb_orthonormal_and_reference_branch():
    # reference `onb.h:7-12`: branch on |w.x| > 0.9
    for n in ([0.0, 0.0, 1.0], [1.0, 0.0, 0.0], [0.3, -0.8, 0.52]):
        basis = rng.onb_from_normal(jnp.array(n))
        b = np.asarray(basis)
        np.testing.assert_allclose(b @ b.T, np.eye(3), atol=1e-5)
        np.testing.assert_allclose(b[2], np.asarray(n) / np.linalg.norm(n), atol=1e-5)
        # right-handedness: u x v = w
        np.testing.assert_allclose(np.cross(b[0], b[1]), b[2], atol=1e-5)


def test_onb_transform_to_world_maps_z_to_normal():
    n = jnp.array([0.0, 1.0, 0.0])
    basis = rng.onb_from_normal(n)
    w = jnp.array([0.0, 0.0, 1.0]) @ basis  # local z-up → world normal
    np.testing.assert_allclose(w, n, atol=1e-6)


def test_jit_compatible():
    @jax.jit
    def f(key):
        return rng.cosine_weighted(key, (8,))

    out = f(rng.key_for(1))
    assert out.shape == (8, 3)
