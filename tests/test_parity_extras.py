"""Parity extras: alternate triangle path, vector helpers, rng.uint, emitted."""

import jax.numpy as jnp
import numpy as np

from ptre.ops import intersect as it
from ptre.ops import materials as mat
from ptre.ops import rng
from ptre.ops import vecmat as vm


def test_plane_edges_matches_moller_trumbore():
    # random triangles + rays: both algorithms must agree on hits and t
    rs = np.random.RandomState(5)
    T, R = 32, 256
    v0 = jnp.asarray(rs.uniform(-1, 1, (T, 3)), jnp.float32)
    v1 = v0 + jnp.asarray(rs.uniform(0.2, 1, (T, 3)), jnp.float32)
    v2 = v0 + jnp.asarray(rs.uniform(-1, -0.2, (T, 3)), jnp.float32)
    valid = jnp.ones((T,), bool)
    o = jnp.asarray(rs.uniform(-3, 3, (R, 3)), jnp.float32)
    d = jnp.asarray(rs.normal(size=(R, 3)), jnp.float32)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)

    t_mt, i_mt, h_mt = it.intersect_triangles(o, d, v0, v1, v2, valid, 1e-4, 999.0)
    t_pe, i_pe, h_pe = it.intersect_triangles_plane_edges(
        o, d, v0, v1, v2, valid, 1e-4, 999.0
    )
    h_mt, h_pe = np.asarray(h_mt), np.asarray(h_pe)
    # near-degenerate grazing hits may differ by epsilon policy; demand 99%
    agree = (h_mt == h_pe).mean()
    assert agree > 0.99, agree
    both = h_mt & h_pe
    np.testing.assert_allclose(
        np.asarray(t_mt)[both], np.asarray(t_pe)[both], rtol=1e-3, atol=1e-4
    )


def test_angle_and_clamp_length():
    a = jnp.array([1.0, 0.0, 0.0])
    b = jnp.array([0.0, 2.0, 0.0])
    np.testing.assert_allclose(vm.angle(a, b), np.pi / 2, atol=1e-6)
    np.testing.assert_allclose(vm.angle(a, a), 0.0, atol=1e-3)
    v = vm.clamp_length(jnp.array([3.0, 4.0, 0.0]), 1.0)
    np.testing.assert_allclose(vm.length(v), 1.0, atol=1e-6)
    v2 = vm.clamp_length(jnp.array([0.3, 0.4, 0.0]), 1.0)
    np.testing.assert_allclose(v2, [0.3, 0.4, 0.0], atol=1e-7)


def test_nan_inf_predicates():
    assert bool(vm.is_nan(jnp.array([1.0, jnp.nan, 0.0])))
    assert not bool(vm.is_nan(jnp.array([1.0, 2.0, 3.0])))
    assert bool(vm.is_inf(jnp.full((4, 4), jnp.inf)))
    assert not bool(vm.is_inf(jnp.eye(4)))


def test_rng_uint():
    u = rng.uint(rng.key_for(1), (10000,), 3, 17)
    a = np.asarray(u)
    assert a.min() >= 3 and a.max() <= 17
    assert set(np.unique(a)) == set(range(3, 18))


def test_emitted():
    kinds = jnp.array([mat.KIND_OREN_NAYAR, mat.KIND_EMISSIVE])
    albedo = jnp.array([[0.5, 0.5, 0.5], [1.0, 0.9, 0.8]])
    param = jnp.array([1.0, 10.0])
    e = np.asarray(mat.emitted(kinds, albedo, param))
    np.testing.assert_allclose(e[0], 0.0)
    np.testing.assert_allclose(e[1], [10.0, 9.0, 8.0])


def test_inverse_singular_returns_infinity():
    # singular -> INFINITY-filled matrix (`matrix.cu:141-145`, eps 0.00001f)
    zero_scale = jnp.diag(jnp.array([0.0, 1.0, 1.0, 1.0], jnp.float32))
    out = vm.inverse(zero_scale)
    assert np.all(np.isinf(np.asarray(out)))
    # well-conditioned matrices still invert exactly
    m = jnp.asarray(np.diag([2.0, 4.0, 0.5, 1.0]).astype(np.float32))
    np.testing.assert_allclose(
        np.asarray(vm.inverse(m)), np.diag([0.5, 0.25, 2.0, 1.0]), atol=1e-6
    )


def test_inverse_singular_gradient_is_finite():
    import jax

    def f(s):
        m = jnp.diag(jnp.array([s, 1.0, 1.0, 1.0], jnp.float32))
        inv = vm.inverse(m)
        return inv[0, 0]

    g = jax.grad(f)(2.0)
    np.testing.assert_allclose(np.asarray(g), -0.25, atol=1e-6)


def test_get_model_read_does_not_dirty_but_mutation_does():
    from ptre.models import demo

    scn = demo.reference_demo_scene(8, 4)
    scn.build_packet()
    assert not scn.modified()
    _ = scn.get_model("sph")  # read: no rebuild (`scene.cu:49` semantics)
    assert not scn.modified()
    scn.get_model("sph").set_transforms(0.5, 0.0, (0.0, 1.0, 0.0))
    assert scn.modified()
    scn.build_packet()
    scn.get_model("sph").set_material(0)
    assert scn.modified()
