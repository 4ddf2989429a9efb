"""Math-core unit tests vs closed-form values and reference conventions."""

import jax.numpy as jnp
import numpy as np
import pytest

from ptre.ops import vecmat as vm


def test_constants():
    assert vm.pi == pytest.approx(np.pi)
    assert vm.tau == pytest.approx(2 * np.pi)
    np.testing.assert_allclose(vm.to_radians(180.0), np.pi, rtol=1e-6)
    np.testing.assert_allclose(vm.to_degrees(np.pi / 2), 90.0, rtol=1e-6)


def test_vector_ops():
    a = jnp.array([1.0, 2.0, 3.0])
    b = jnp.array([4.0, -5.0, 6.0])
    np.testing.assert_allclose(vm.dot(a, b), 1 * 4 - 2 * 5 + 3 * 6)
    np.testing.assert_allclose(vm.cross(a, b), np.cross(a, b), atol=1e-6)
    np.testing.assert_allclose(vm.length(jnp.array([3.0, 4.0, 0.0])), 5.0)
    np.testing.assert_allclose(vm.hadamard(a, b), [4.0, -10.0, 18.0])


def test_normalize_zero_safe():
    # reference `vector.h:239-244`: zero vectors normalize to zero
    z = vm.normalize(jnp.zeros(3))
    np.testing.assert_allclose(z, np.zeros(3))
    v = vm.normalize(jnp.array([0.0, 10.0, 0.0]))
    np.testing.assert_allclose(v, [0.0, 1.0, 0.0], atol=1e-7)


def test_reflect():
    v = jnp.array([1.0, -1.0, 0.0])
    n = jnp.array([0.0, 1.0, 0.0])
    np.testing.assert_allclose(vm.reflect(v, n), [1.0, 1.0, 0.0], atol=1e-6)


def test_refract_and_tir():
    n = jnp.array([0.0, 1.0, 0.0])
    v = vm.normalize(jnp.array([1.0, -1.0, 0.0]))
    r = vm.refract(v, n, 0.5)
    # Snell: sin_t = eta * sin_i
    sin_t = float(jnp.abs(r[0]) / vm.length(r))
    np.testing.assert_allclose(sin_t, 0.5 * np.sin(np.pi / 4), atol=1e-6)
    # total internal reflection falls back to reflect
    r_tir = vm.refract(v, n, 3.0)
    np.testing.assert_allclose(r_tir, vm.reflect(v, n), atol=1e-6)


def test_swizzle():
    v = jnp.array([1.0, 2.0, 3.0, 4.0])
    np.testing.assert_allclose(vm.swizzle(v, "wzyx"), [4.0, 3.0, 2.0, 1.0])


def test_translate_row_vector_convention():
    # reference `matrix.cu:367-373`: translation in row 3, applied as v @ M
    m = vm.translate(jnp.array([1.0, 2.0, 3.0]))
    p = vm.transform_points(jnp.array([1.0, 1.0, 1.0]), m)
    np.testing.assert_allclose(p, [2.0, 3.0, 4.0])
    d = vm.transform_dirs(jnp.array([1.0, 1.0, 1.0]), m)
    np.testing.assert_allclose(d, [1.0, 1.0, 1.0])


def test_rotation_directions():
    # reference row-vector rotations: v @ Rz(90deg) maps +x to +y
    p = vm.transform_points(jnp.array([1.0, 0.0, 0.0]), vm.rotation_z(jnp.pi / 2))
    np.testing.assert_allclose(p, [0.0, 1.0, 0.0], atol=1e-6)
    p = vm.transform_points(jnp.array([0.0, 1.0, 0.0]), vm.rotation_x(jnp.pi / 2))
    np.testing.assert_allclose(p, [0.0, 0.0, 1.0], atol=1e-6)
    p = vm.transform_points(jnp.array([0.0, 0.0, 1.0]), vm.rotation_y(jnp.pi / 2))
    np.testing.assert_allclose(p, [1.0, 0.0, 0.0], atol=1e-6)


def test_rotation_axis_matches_elementary():
    ang = 0.7
    np.testing.assert_allclose(
        vm.rotation_axis(ang, jnp.array([0.0, 0.0, 1.0])), vm.rotation_z(ang), atol=1e-6
    )
    np.testing.assert_allclose(
        vm.rotation_axis(ang, jnp.array([1.0, 0.0, 0.0])), vm.rotation_x(ang), atol=1e-6
    )


def test_compose_trs_order():
    # `model.cu:11-18`: v @ (S @ Rz @ T) = scale, then rotate, then translate
    m = vm.compose_trs(
        jnp.array([2.0, 2.0, 2.0]),
        jnp.array([0.0, 0.0, jnp.pi / 2]),
        jnp.array([10.0, 0.0, 0.0]),
    )
    p = vm.transform_points(jnp.array([1.0, 0.0, 0.0]), m)
    np.testing.assert_allclose(p, [10.0, 2.0, 0.0], atol=1e-5)


def test_look_at_properties():
    eye = jnp.array([0.0, 0.5, -3.0])
    focus = jnp.array([0.0, 0.0, 0.0])
    v = vm.look_at(eye, focus)
    # eye maps to origin
    np.testing.assert_allclose(vm.transform_points(eye, v), [0.0, 0.0, 0.0], atol=1e-6)
    # focus lands on +z axis (LH forward)
    f = vm.transform_points(focus, v)
    np.testing.assert_allclose(f[:2], [0.0, 0.0], atol=1e-6)
    assert f[2] > 0


def test_look_at_non_orthonormal_parity():
    # the reference does NOT normalize right/up (`matrix.cu:315-324`):
    # for a tilted forward, columns are non-unit — verify we reproduce that
    eye = jnp.array([0.0, 0.5, -3.0])
    v = vm.look_at(eye, eye + jnp.array([0.0, -0.5, 3.0]))
    right = np.asarray(v)[:3, 0]
    assert not np.isclose(np.linalg.norm(right), 1.0)  # faithfully non-unit


def test_perspective_d3d_z01():
    znear, zfar = 0.01, 100.0
    m = vm.perspective(16 / 9, vm.to_radians(45.0), znear, zfar)
    # near-plane point on axis → z/w = 0; far-plane → z/w = 1
    pn, wn = vm.transform_points_h(jnp.array([0.0, 0.0, znear]), m)
    np.testing.assert_allclose(pn[2] / wn, 0.0, atol=1e-6)
    pf, wf = vm.transform_points_h(jnp.array([0.0, 0.0, zfar]), m)
    np.testing.assert_allclose(pf[2] / wf, 1.0, atol=1e-5)
    # w equals view z (LH, m[2][3] = 1)
    np.testing.assert_allclose(wf, zfar, rtol=1e-6)
    # degenerate → INFINITY matrix like `matrix.cu:343-345`
    bad = vm.perspective(1.0, 1.0, 5.0, 5.0)
    assert np.all(np.isinf(bad))


def test_orthographic_d3d():
    m = vm.orthographic(1.0, 1.0, 11.0)
    # 2 units tall: y = ±1 maps to ±1
    p, w = vm.transform_points_h(jnp.array([0.0, 1.0, 1.0]), m)
    np.testing.assert_allclose(w, 1.0)
    np.testing.assert_allclose(p[1], 1.0, atol=1e-6)
    np.testing.assert_allclose(p[2], 0.0, atol=1e-6)  # znear → 0
    p2, _ = vm.transform_points_h(jnp.array([0.0, 0.0, 11.0]), m)
    np.testing.assert_allclose(p2[2], 1.0, atol=1e-6)  # zfar → 1


def test_normal_matrix_vs_reference_spelling():
    m = vm.compose_trs(
        jnp.array([2.0, 3.0, 4.0]),
        jnp.array([0.3, -0.2, 0.9]),
        jnp.array([5.0, 6.0, 7.0]),
    )
    n = vm.normal_matrix(m)
    m3 = np.asarray(m)[:3, :3]
    # path tracer spelling: inv(M3^T) applied as row-vector (`path_tracer.cu:260`)
    np.testing.assert_allclose(n, np.linalg.inv(m3.T).T.T, atol=1e-5)
    np.testing.assert_allclose(n, np.linalg.inv(m3).T, atol=1e-5)
    # a normal stays perpendicular under non-uniform scale
    nrm = vm.transform_normals(jnp.array([0.0, 1.0, 0.0]), vm.scale(jnp.array([2.0, 1.0, 1.0])))
    tangent = vm.transform_dirs(jnp.array([1.0, 0.0, 0.0]), vm.scale(jnp.array([2.0, 1.0, 1.0])))
    np.testing.assert_allclose(vm.dot(nrm, tangent), 0.0, atol=1e-6)


def test_inverse_roundtrip():
    m = vm.compose_trs(
        jnp.array([2.0, 3.0, 4.0]),
        jnp.array([0.3, -0.2, 0.9]),
        jnp.array([5.0, 6.0, 7.0]),
    )
    np.testing.assert_allclose(m @ vm.inverse(m), np.eye(4), atol=1e-5)
