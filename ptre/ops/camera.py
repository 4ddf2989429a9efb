"""Camera: shared inverse-raster-pipeline ray generation.

JAX equivalent of the reference camera (`IoniqRE/camera.{h,cu}`), which
lives in CUDA managed memory so the rasterizer reads view/projection on the
host while the path tracer unprojects rays on the device
(`application.cu:16-17`). Here the camera is a differentiable pytree: the same
object feeds the rasterizer (view/projection matrices) and the path tracer
(batched inverse-projection ray generation, `camera.cu:20-43`), so the two
engines remain directly A/B-comparable — the reference's defining property.

Defaults mirror `camera.h:11,26-27`: position (0, 0.5, -3), forward
(0, -0.5, 3), vertical fov 45 deg, znear 0.01, zfar 100.
"""

from __future__ import annotations

import jax.numpy as jnp

from ptre.ops import vecmat as vm
from ptre.utils import pytree

PERSPECTIVE = 0
ORTHOGRAPHIC = 1


@pytree.dataclass
class Camera:
    """Differentiable pin-hole / orthographic camera.

    width/height/projection are static (they change compiled shapes or code
    paths); position, forward, fov and clip planes are differentiable leaves.
    """

    position: jnp.ndarray  # (3,)
    forward: jnp.ndarray  # (3,) — NOT normalized; look_at normalizes
    fov_degrees: jnp.ndarray  # () vertical fov
    znear: jnp.ndarray  # ()
    zfar: jnp.ndarray  # ()
    width: int = pytree.static_field(default=1280)
    height: int = pytree.static_field(default=720)
    projection: int = pytree.static_field(default=PERSPECTIVE)

    @classmethod
    def create(
        cls,
        width: int = 1280,
        height: int = 720,
        position=(0.0, 0.5, -3.0),
        forward=(0.0, -0.5, 3.0),
        fov_degrees: float = 45.0,
        znear: float = 0.01,
        zfar: float = 100.0,
        projection: int = PERSPECTIVE,
    ) -> "Camera":
        return cls(
            position=jnp.asarray(position, jnp.float32),
            forward=jnp.asarray(forward, jnp.float32),
            fov_degrees=jnp.asarray(fov_degrees, jnp.float32),
            znear=jnp.asarray(znear, jnp.float32),
            zfar=jnp.asarray(zfar, jnp.float32),
            width=width,
            height=height,
            projection=projection,
        )

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def view_matrix(self):
        """LH look_at view matrix (`camera.cu:11`)."""
        return vm.look_at(self.position, self.position + self.forward)

    def projection_matrix(self):
        """D3D z in [0,1] projection (`camera.cu:12-13`)."""
        if self.projection == ORTHOGRAPHIC:
            return vm.orthographic(self.aspect, self.znear, self.zfar)
        return vm.perspective(
            self.aspect, vm.to_radians(self.fov_degrees), self.znear, self.zfar
        )

    def view_proj(self):
        return vm.matmul(self.view_matrix(), self.projection_matrix())


def get_rays(cam: Camera, px, py, jitter):
    """Generate world-space rays through pixel centers + jitter (`camera.cu:20-43`).

    Runs the raster pipeline in reverse, exactly like the reference: screen →
    NDC, unproject the near (z=0) and far (z=1) NDC points through inv(proj)
    with w-divide, then through inv(view); the ray starts at the near point
    toward the far point.

    Args:
      cam: Camera.
      px, py: (...,) pixel integer coordinates (x right, y down).
      jitter: (..., 2) sub-pixel offsets in [-0.5, 0.5) (use zeros for centers).

    Returns:
      (origins, directions): (..., 3) each; directions normalized.
    """
    inv_view = vm.inverse(cam.view_matrix())
    inv_proj = vm.inverse(cam.projection_matrix())

    x_ndc = ((px + jitter[..., 0]) / cam.width) * 2.0 - 1.0
    y_ndc = 1.0 - ((py + jitter[..., 1]) / cam.height) * 2.0

    ndc_near = jnp.stack([x_ndc, y_ndc, jnp.zeros_like(x_ndc)], axis=-1)
    ndc_far = jnp.stack([x_ndc, y_ndc, jnp.ones_like(x_ndc)], axis=-1)

    view_near, w_near = vm.transform_points_h(ndc_near, inv_proj)
    view_near = view_near / w_near[..., None]
    view_far, w_far = vm.transform_points_h(ndc_far, inv_proj)
    view_far = view_far / w_far[..., None]

    world_near = vm.transform_points(view_near, inv_view)
    world_far = vm.transform_points(view_far, inv_view)

    direction = vm.normalize(world_far - world_near)
    # pinned as float remat residuals: primary rays are the root of every
    # downstream Jacobian; saving them (6 floats/ray, once per sample)
    # keeps the rematerialized backward's linearization point bit-equal to
    # the forward's (ops/gradsafe.py). Identity outside jax.checkpoint.
    from ptre.ops import gradsafe

    return gradsafe.remat_pin(world_near), gradsafe.remat_pin(direction)
