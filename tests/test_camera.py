"""Camera ray-generation tests vs closed-form geometry (`camera.cu:20-43`)."""

import jax.numpy as jnp
import numpy as np

from ptre.ops import camera as cam_ops
from ptre.ops import vecmat as vm


def _centered_cam(w=64, h=64, fov=90.0):
    return cam_ops.Camera.create(
        width=w, height=h, position=(0.0, 0.0, 0.0), forward=(0.0, 0.0, 1.0),
        fov_degrees=fov,
    )


def test_center_ray_is_forward():
    cam = _centered_cam()
    o, d = cam_ops.get_rays(cam, jnp.array([32.0]), jnp.array([32.0]), jnp.zeros((1, 2)))
    np.testing.assert_allclose(d[0], [0.0, 0.0, 1.0], atol=1e-5)
    # origin sits on the near plane along the ray
    np.testing.assert_allclose(o[0], [0.0, 0.0, 0.01], atol=1e-5)


def test_fov_edges():
    # 90 deg vertical fov, square aspect: top-center ray at 45 deg elevation
    cam = _centered_cam(fov=90.0)
    o, d = cam_ops.get_rays(cam, jnp.array([32.0]), jnp.array([0.0]), jnp.zeros((1, 2)))
    # y_ndc = 1 → tan = 1 → direction (0, 1, 1)/sqrt(2)
    np.testing.assert_allclose(d[0], np.array([0.0, 1.0, 1.0]) / np.sqrt(2), atol=1e-4)


def test_reference_default_pose():
    cam = cam_ops.Camera.create(width=1280, height=720)
    o, d = cam_ops.get_rays(
        cam, jnp.array([640.0]), jnp.array([360.0]), jnp.zeros((1, 2))
    )
    fwd = np.asarray(vm.normalize(jnp.array([0.0, -0.5, 3.0])))
    np.testing.assert_allclose(d[0], fwd, atol=1e-5)
    # ray origin ≈ camera position + znear * forward (near-plane point)
    np.testing.assert_allclose(o[0], np.array([0.0, 0.5, -3.0]) + 0.01 * fwd, atol=1e-4)


def test_y_axis_points_down_in_screen_space():
    cam = _centered_cam()
    _, d_top = cam_ops.get_rays(cam, jnp.array([32.0]), jnp.array([5.0]), jnp.zeros((1, 2)))
    _, d_bot = cam_ops.get_rays(cam, jnp.array([32.0]), jnp.array([58.0]), jnp.zeros((1, 2)))
    assert float(d_top[0, 1]) > 0.0 > float(d_bot[0, 1])


def test_orthographic_rays_parallel():
    cam = cam_ops.Camera.create(
        width=32, height=32, position=(0.0, 0.0, 0.0), forward=(0.0, 0.0, 1.0),
        projection=cam_ops.ORTHOGRAPHIC,
    )
    px = jnp.array([0.0, 8.0, 31.0])
    py = jnp.array([0.0, 16.0, 31.0])
    o, d = cam_ops.get_rays(cam, px, py, jnp.zeros((3, 2)))
    np.testing.assert_allclose(d, np.tile([[0.0, 0.0, 1.0]], (3, 1)), atol=1e-5)
    # origins differ (parallel projection)
    assert not np.allclose(o[0], o[1])


def test_view_proj_roundtrip():
    # unprojecting the projection of a world point lands on the same ray
    cam = cam_ops.Camera.create(width=128, height=128)
    world = jnp.array([0.3, 0.2, 1.0])
    vp = cam.view_proj()
    ndc, w = vm.project_points(world, vp)
    # NDC → pixel
    px = (ndc[0] + 1.0) * 0.5 * cam.width - 0.0
    py = (1.0 - ndc[1]) * 0.5 * cam.height
    o, d = cam_ops.get_rays(cam, px[None], py[None], jnp.full((1, 2), 0.0) - 0.0)
    # o + t d should pass through `world`
    t = vm.dot(world - o[0], d[0])
    closest = o[0] + t * d[0]
    np.testing.assert_allclose(closest, world, atol=1e-3)


def test_differentiable_wrt_pose():
    import jax

    cam = _centered_cam()

    def f(pos):
        c = cam.replace(position=pos)
        o, d = cam_ops.get_rays(c, jnp.array([10.0]), jnp.array([20.0]), jnp.zeros((1, 2)))
        return jnp.sum(o) + jnp.sum(d)

    g = jax.grad(f)(jnp.zeros(3))
    assert np.all(np.isfinite(np.asarray(g)))
    assert float(jnp.abs(g).sum()) > 0
