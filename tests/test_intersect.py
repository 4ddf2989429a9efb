"""Ray–primitive intersection tests vs closed-form values (`shape.cu`)."""

import jax.numpy as jnp
import numpy as np

from ptre.models import mesh as mg
from ptre.models.scene import Model, Scene
from ptre.ops import intersect as it


def _rays(os_, ds_):
    o = jnp.asarray(os_, jnp.float32).reshape(-1, 3)
    d = jnp.asarray(ds_, jnp.float32).reshape(-1, 3)
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def test_sphere_basic_hit():
    o, d = _rays([0.0, 0.0, -3.0], [0.0, 0.0, 1.0])
    c = jnp.array([[0.0, 0.0, 0.0]])
    r = jnp.array([1.0])
    valid = jnp.array([True])
    t, idx, hit = it.intersect_spheres(o, d, c, r, valid, 1e-6, 999.99)
    assert bool(hit[0])
    np.testing.assert_allclose(t[0], 2.0, atol=1e-5)
    p, n, front = it.sphere_hit_attrs(o, d, t, c[idx], r[idx])
    np.testing.assert_allclose(p[0], [0.0, 0.0, -1.0], atol=1e-5)
    np.testing.assert_allclose(n[0], [0.0, 0.0, -1.0], atol=1e-5)
    assert bool(front[0])


def test_sphere_inside_hits_far_root_with_flipped_normal():
    o, d = _rays([0.0, 0.0, 0.0], [0.0, 0.0, 1.0])
    c = jnp.array([[0.0, 0.0, 0.0]])
    r = jnp.array([1.0])
    t, idx, hit = it.intersect_spheres(o, d, c, r, jnp.array([True]), 1e-6, 999.99)
    assert bool(hit[0])
    np.testing.assert_allclose(t[0], 1.0, atol=1e-5)  # far root (`shape.cu:31-36`)
    p, n, front = it.sphere_hit_attrs(o, d, t, c[idx], r[idx])
    assert not bool(front[0])
    np.testing.assert_allclose(n[0], [0.0, 0.0, -1.0], atol=1e-5)  # flipped inward


def test_sphere_miss_and_tmax():
    o, d = _rays([[0.0, 5.0, -3.0], [0.0, 0.0, -3.0]], [[0.0, 0.0, 1.0]] * 2)
    c = jnp.array([[0.0, 0.0, 0.0]])
    r = jnp.array([1.0])
    valid = jnp.array([True])
    t, _, hit = it.intersect_spheres(o, d, c, r, valid, 1e-6, 999.99)
    assert not bool(hit[0]) and bool(hit[1])
    # near root beyond t_max rejects the sphere entirely (`shape.cu:26-28`)
    t, _, hit = it.intersect_spheres(o, d, c, r, valid, 1e-6, 1.5)
    assert not bool(hit[1])


def test_sphere_behind_ray_misses():
    o, d = _rays([0.0, 0.0, 3.0], [0.0, 0.0, 1.0])
    t, _, hit = it.intersect_spheres(
        o, d, jnp.array([[0.0, 0.0, 0.0]]), jnp.array([1.0]), jnp.array([True]), 1e-6, 999.99
    )
    assert not bool(hit[0])


def test_sphere_closest_of_many():
    o, d = _rays([0.0, 0.0, -5.0], [0.0, 0.0, 1.0])
    c = jnp.array([[0.0, 0.0, 2.0], [0.0, 0.0, 0.0], [0.0, 0.0, 4.0]])
    r = jnp.array([1.0, 1.0, 1.0])
    valid = jnp.array([True, True, True])
    t, idx, hit = it.intersect_spheres(o, d, c, r, valid, 1e-6, 999.99)
    assert int(idx[0]) == 1 and bool(hit[0])
    np.testing.assert_allclose(t[0], 4.0, atol=1e-5)


def test_triangle_moller_trumbore():
    # unit triangle in z=0 plane
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    v1 = jnp.array([[1.0, 0.0, 0.0]])
    v2 = jnp.array([[0.0, 1.0, 0.0]])
    valid = jnp.array([True])
    o, d = _rays([0.2, 0.2, -2.0], [0.0, 0.0, 1.0])
    t, idx, hit = it.intersect_triangles(o, d, v0, v1, v2, valid, 1e-6, 999.99)
    assert bool(hit[0])
    np.testing.assert_allclose(t[0], 2.0, atol=1e-5)
    # outside barycentric range misses
    o2, d2 = _rays([0.7, 0.7, -2.0], [0.0, 0.0, 1.0])
    _, _, hit2 = it.intersect_triangles(o2, d2, v0, v1, v2, valid, 1e-6, 999.99)
    assert not bool(hit2[0])
    # parallel ray misses (det ~ 0, `shape.cu:70-74`)
    o3, d3 = _rays([0.2, 0.2, -2.0], [1.0, 0.0, 0.0])
    _, _, hit3 = it.intersect_triangles(o3, d3, v0, v1, v2, valid, 1e-6, 999.99)
    assert not bool(hit3[0])


def test_triangle_no_backface_culling_and_flip():
    # winding chosen so the geometric normal e1 x e2 = (0,0,-1) agrees with
    # the vertex normals — the reference flips the smooth normal by the sign
    # of dot(d, geometric normal) (`shape.cu:98-101`)
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    v1 = jnp.array([[0.0, 1.0, 0.0]])
    v2 = jnp.array([[1.0, 0.0, 0.0]])
    n = jnp.array([[0.0, 0.0, -1.0]])
    valid = jnp.array([True])
    # from both sides
    for oz, expect_n in ((-2.0, [0.0, 0.0, -1.0]), (2.0, [0.0, 0.0, 1.0])):
        o, d = _rays([0.2, 0.2, oz], [0.0, 0.0, -np.sign(oz)])
        t, idx, hit = it.intersect_triangles(o, d, v0, v1, v2, valid, 1e-6, 999.99)
        assert bool(hit[0])
        p, nn, front = it.triangle_hit_attrs(
            o, d, t, v0[idx], v1[idx], v2[idx], n[idx], n[idx], n[idx]
        )
        np.testing.assert_allclose(nn[0], expect_n, atol=1e-5)


def test_triangle_smooth_normal_interpolation():
    # winding consistent with the -z corner normals (geo normal = -z)
    v0 = jnp.array([[0.0, 0.0, 0.0]])
    v1 = jnp.array([[0.0, 1.0, 0.0]])
    v2 = jnp.array([[1.0, 0.0, 0.0]])
    # distinct corner normals, all facing -z hemisphere
    n0 = jnp.array([[0.0, 0.0, -1.0]])
    n1 = jnp.array([[-0.5, 0.0, -1.0]]) / np.sqrt(1.25)
    n2 = jnp.array([[0.0, -0.5, -1.0]]) / np.sqrt(1.25)
    o, d = _rays([0.25, 0.25, -2.0], [0.0, 0.0, 1.0])
    t = jnp.array([2.0])
    p, nn, front = it.triangle_hit_attrs(o, d, t, v0, v1, v2, n0, n1, n2)
    # u = v = 0.25 → n = 0.5 n0 + 0.25 n1 + 0.25 n2, normalized (`shape.cu:96-97`)
    expect = 0.5 * np.asarray(n0[0]) + 0.25 * np.asarray(n1[0]) + 0.25 * np.asarray(n2[0])
    expect /= np.linalg.norm(expect)
    np.testing.assert_allclose(nn[0], expect, atol=1e-5)


def _demo_packet():
    from ptre.models import demo

    scn = demo.reference_demo_scene(8, 4)
    return scn.build_packet(tri_pad=8, sph_pad=4)


def test_closest_hit_demo_scene():
    pkt = _demo_packet()
    wt = pkt.world_triangles()
    # ray at the unit sphere at (0, 0.5, 0) from the reference camera pose
    o, d = _rays([0.0, 0.5, -3.0], [0.0, 0.0, 1.0])
    hr = it.closest_hit(o, d, pkt, wt, 1e-6, 999.99)
    assert bool(hr.hit[0])
    np.testing.assert_allclose(hr.t[0], 2.5, atol=1e-5)  # sphere r=0.5
    assert int(hr.mat_id[0]) == 0  # oren-nayar
    # ray at the cube wall at (1, 0.5, 0)
    o, d = _rays([1.0, 0.5, -3.0], [0.0, 0.0, 1.0])
    hr = it.closest_hit(o, d, pkt, wt, 1e-6, 999.99)
    assert bool(hr.hit[0])
    np.testing.assert_allclose(hr.t[0], 2.5, atol=1e-4)  # cube half-extent 0.5
    assert int(hr.mat_id[0]) == 1  # emissive
    # sky ray
    o, d = _rays([0.0, 0.5, -3.0], [0.0, 1.0, 0.0])
    hr = it.closest_hit(o, d, pkt, wt, 1e-6, 999.99)
    assert not bool(hr.hit[0])


def test_closest_hit_sphere_occludes_triangle():
    # sphere in front of the cube: sphere wins
    scn = Scene()
    scn.add_mesh("cube", mg.cube())
    scn.add_mesh("ball", mg.uv_sphere(False, 4, 3))
    scn.add_model("wall", Model("cube"))
    scn.get_model("wall").set_transforms(1.0, 0.0, (0.0, 0.0, 5.0))
    scn.add_model("s", Model("ball"))
    scn.get_model("s").set_transforms(1.0, 0.0, (0.0, 0.0, 2.0))
    pkt = scn.build_packet(tri_pad=8, sph_pad=4)
    o, d = _rays([0.0, 0.0, -3.0], [0.0, 0.0, 1.0])
    hr = it.closest_hit(o, d, pkt, pkt.world_triangles(), 1e-6, 999.99)
    np.testing.assert_allclose(hr.t[0], 4.0, atol=1e-5)  # sphere front face
    assert int(hr.mat_id[0]) == 0
    # and triangle wins when nearer: move the sphere behind
    scn.get_model("s").set_transforms(1.0, 0.0, (0.0, 0.0, 20.0))
    pkt = scn.build_packet(tri_pad=8, sph_pad=4)
    hr = it.closest_hit(o, d, pkt, pkt.world_triangles(), 1e-6, 999.99)
    np.testing.assert_allclose(hr.t[0], 7.5, atol=1e-4)  # cube front face at z=4.5
    assert int(hr.mat_id[0]) == 1
