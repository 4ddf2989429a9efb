"""Vector / matrix math core (row-vector, HLSL/D3D conventions).

JAX equivalent of the reference math library
(`IoniqRE/vector.h`, `IoniqRE/matrix.{h,cu}`, `IoniqRE/iqmath.h`).

Conventions (matching the reference exactly):
  * 4x4 matrices act on ROW vectors: ``transformed = v @ M``; the translation
    lives in row 3 (``M[3, :3]``), like ``iqmat::translate``
    (reference `matrix.cu:367-373`).
  * Composition order is left-to-right application: ``v @ (A @ B)`` applies A
    first, then B. A model transform is ``S @ R @ T``
    (reference `model.cu:11-18`).
  * Points carry w=1 and directions w=0 before a 4x4 transform, mirroring the
    `iqvec::usage::{POINT,DIRECTION}` tags (reference `vector.h:371-388`).
  * Projection matrices are D3D-style left-handed with clip z in [0, 1]
    (reference `matrix.cu:325-357`).
  * ``look_at`` intentionally does NOT orthonormalize right/up — the reference
    builds ``right = (0,1,0) x forward`` without normalizing
    (`matrix.cu:315-324`), and golden parity requires reproducing that.

All functions are pure jnp, broadcastable over leading batch dimensions, and
safe under `jit`/`grad`/`vmap`.

Every contraction in the renderer goes through `einsum` / `matmul` below,
which pin ``Precision.HIGHEST``: a float32 matrix product may otherwise run
in TF32 on a GPU, which keeps about three decimal digits and would move hit
points by ~1e-3 of the scene scale.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

#: precision of every geometry contraction (full float32; see module doc)
HIGHEST = jax.lax.Precision.HIGHEST


def einsum(spec, *operands):
    """`jnp.einsum` in full float32 (``Precision.HIGHEST``)."""
    return jnp.einsum(spec, *operands, precision=HIGHEST)


def matmul(a, b):
    """`jnp.matmul` in full float32 (``Precision.HIGHEST``)."""
    return jnp.matmul(a, b, precision=HIGHEST)


# ---------------------------------------------------------------------------
# Constants (reference `iqmath.h:8-13`)
# ---------------------------------------------------------------------------

pi = math.pi
tau = 2.0 * math.pi
pi_div_2 = math.pi / 2.0
pi_div_4 = math.pi / 4.0
one_div_pi = 1.0 / math.pi
one_div_2pi = 1.0 / (2.0 * math.pi)

#: epsilon used by `is_zero` (reference `iqmath.h:29-31`)
IS_ZERO_EPS = 1e-6


def to_radians(degrees):
    return jnp.asarray(degrees) * (pi / 180.0)


def to_degrees(radians):
    return jnp.asarray(radians) * (180.0 / pi)


def is_zero(x, eps: float = IS_ZERO_EPS):
    """|x| < eps predicate (reference `iqmath.h:29-31`)."""
    return jnp.abs(x) < eps


# ---------------------------------------------------------------------------
# Vector ops (reference `vector.h`)
# ---------------------------------------------------------------------------


def vec3(x, y, z, dtype=jnp.float32):
    return jnp.stack(
        [jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)], axis=-1
    )


def dot(a, b):
    """Batched dot over the trailing axis (dot3/dot4 — `vector.h`)."""
    return jnp.sum(a * b, axis=-1)


def length_sq(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_sq(v))


def cross(a, b):
    """3D cross product (reference `vector.h:219-224`)."""
    return jnp.cross(a, b)


def hadamard(a, b):
    """Component-wise product (reference `vector.h:107-109`)."""
    return a * b


def normalize(v, eps: float = 0.0):
    """Zero-safe normalize: zero vectors stay zero (reference `vector.h:239-244`)."""
    len_sq = jnp.sum(v * v, axis=-1, keepdims=True)
    inv = jnp.where(len_sq > eps, 1.0 / jnp.sqrt(jnp.where(len_sq > 0, len_sq, 1.0)), 0.0)
    return v * inv


def angle(a, b):
    """Angle between vectors in radians (reference `vector.h` angle3)."""
    la = length(a)
    lb = length(b)
    denom = jnp.where(la * lb > 0, la * lb, 1.0)
    return jnp.arccos(jnp.clip(dot(a, b) / denom, -1.0, 1.0))


def clamp_length(v, max_len):
    """Clamp a vector's length (reference `vector.h` clamp_length)."""
    l = length(v)[..., None]
    scale = jnp.where(l > max_len, max_len / jnp.where(l > 0, l, 1.0), 1.0)
    return v * scale


def is_nan(x):
    """Any-NaN predicate over the trailing dims (reference `vector.h:236-238`,
    `matrix.cu:307-313`)."""
    return jnp.any(jnp.isnan(x), axis=tuple(range(-min(x.ndim, 2), 0)))


def is_inf(x):
    """Any-inf predicate (reference `matrix.cu:292-305`)."""
    return jnp.any(jnp.isinf(x), axis=tuple(range(-min(x.ndim, 2), 0)))


def reflect(v, n):
    """Reflect v about normal n (reference `vector.h` reflect)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v, n, eta):
    """Refract with total-internal-reflection fallback (reference `vector.h:260-269`).

    `eta` is the relative index of refraction n1/n2; falls back to reflection
    when the discriminant is negative.
    """
    v = jnp.asarray(v)
    cos_i = -dot(v, n)
    disc = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = disc < 0.0
    s = eta * cos_i - jnp.sqrt(jnp.maximum(disc, 0.0))
    refracted = eta * v + s[..., None] * n
    return jnp.where(tir[..., None], reflect(v, n), refracted)


_SWIZZLE_IDX = {"x": 0, "y": 1, "z": 2, "w": 3}


def swizzle(v, permutation: str):
    """String swizzle, e.g. ``swizzle(v, "zyx")`` (reference `vector.h:351-368`)."""
    idx = tuple(_SWIZZLE_IDX[c] for c in permutation)
    return jnp.stack([v[..., i] for i in idx], axis=-1)


# ---------------------------------------------------------------------------
# 4x4 matrix factories (reference `matrix.cu`)
# ---------------------------------------------------------------------------


def identity(dtype=jnp.float32):
    return jnp.eye(4, dtype=dtype)


def scale(factor):
    """Scale matrix; accepts scalar or (..., 3) (reference `matrix.cu:359-365`)."""
    factor = jnp.asarray(factor, jnp.float32)
    if factor.ndim == 0:
        factor = jnp.broadcast_to(factor, (3,))
    batch = factor.shape[:-1]
    m = jnp.zeros(batch + (4, 4), jnp.float32)
    m = m.at[..., 0, 0].set(factor[..., 0])
    m = m.at[..., 1, 1].set(factor[..., 1])
    m = m.at[..., 2, 2].set(factor[..., 2])
    m = m.at[..., 3, 3].set(1.0)
    return m


def translate(offset):
    """Translation in row 3 (row-vector convention — `matrix.cu:367-373`)."""
    offset = jnp.asarray(offset, jnp.float32)
    batch = offset.shape[:-1]
    m = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), batch + (4, 4))
    return m.at[..., 3, :3].set(offset[..., :3])


def rotation_x(angle):
    """Rotation about x (reference `matrix.cu:375-385`)."""
    angle = jnp.asarray(angle, jnp.float32)
    s, c = jnp.sin(angle), jnp.cos(angle)
    m = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), angle.shape + (4, 4))
    m = m.at[..., 1, 1].set(c)
    m = m.at[..., 1, 2].set(s)
    m = m.at[..., 2, 1].set(-s)
    m = m.at[..., 2, 2].set(c)
    return m


def rotation_y(angle):
    """Rotation about y (reference `matrix.cu:387-397`)."""
    angle = jnp.asarray(angle, jnp.float32)
    s, c = jnp.sin(angle), jnp.cos(angle)
    m = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), angle.shape + (4, 4))
    m = m.at[..., 0, 0].set(c)
    m = m.at[..., 0, 2].set(-s)
    m = m.at[..., 2, 0].set(s)
    m = m.at[..., 2, 2].set(c)
    return m


def rotation_z(angle):
    """Rotation about z (reference `matrix.cu:399-409`)."""
    angle = jnp.asarray(angle, jnp.float32)
    s, c = jnp.sin(angle), jnp.cos(angle)
    m = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), angle.shape + (4, 4))
    m = m.at[..., 0, 0].set(c)
    m = m.at[..., 0, 1].set(s)
    m = m.at[..., 1, 0].set(-s)
    m = m.at[..., 1, 1].set(c)
    return m


def rotation_axis(angle, axis):
    """Axis-angle rotation (reference `matrix.cu:411-428`). Axis assumed unit."""
    angle = jnp.asarray(angle, jnp.float32)
    axis = jnp.asarray(axis, jnp.float32)
    s, c = jnp.sin(angle), jnp.cos(angle)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    omc = 1.0 - c
    m = jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), jnp.shape(angle) + (4, 4))
    m = m.at[..., 0, 0].set(c + x * x * omc)
    m = m.at[..., 0, 1].set(y * x * omc + z * s)
    m = m.at[..., 0, 2].set(z * x * omc - y * s)
    m = m.at[..., 1, 0].set(x * y * omc - z * s)
    m = m.at[..., 1, 1].set(c + y * y * omc)
    m = m.at[..., 1, 2].set(z * y * omc + x * s)
    m = m.at[..., 2, 0].set(x * z * omc + y * s)
    m = m.at[..., 2, 1].set(y * z * omc - x * s)
    m = m.at[..., 2, 2].set(c + z * z * omc)
    return m


def compose_trs(scale_v, rotation_euler, translation):
    """Model transform ``S @ Rx @ Ry @ Rz @ T`` (reference `model.cu:11-18`)."""
    rotation_euler = jnp.asarray(rotation_euler, jnp.float32)
    r = matmul(matmul(rotation_x(rotation_euler[..., 0]),
                      rotation_y(rotation_euler[..., 1])),
               rotation_z(rotation_euler[..., 2]))
    return matmul(matmul(scale(scale_v), r), translate(translation))


def look_at(eye, focus):
    """Left-handed view matrix (reference `matrix.cu:315-324`).

    NOTE: faithfully non-orthonormalized — ``right = (0,1,0) x forward`` and
    ``up = forward x right`` are NOT normalized, exactly like the reference.
    """
    eye = jnp.asarray(eye, jnp.float32)
    focus = jnp.asarray(focus, jnp.float32)
    aux = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    forward = normalize(focus - eye)
    right = jnp.cross(jnp.broadcast_to(aux, forward.shape), forward)
    up = jnp.cross(forward, right)
    batch = forward.shape[:-1]
    m = jnp.zeros(batch + (4, 4), jnp.float32)
    m = m.at[..., :3, 0].set(right)
    m = m.at[..., :3, 1].set(up)
    m = m.at[..., :3, 2].set(forward)
    m = m.at[..., 3, 0].set(-dot(right, eye))
    m = m.at[..., 3, 1].set(-dot(up, eye))
    m = m.at[..., 3, 2].set(-dot(forward, eye))
    m = m.at[..., 3, 3].set(1.0)
    return m


def perspective(aspect_ratio, fovh, znear, zfar):
    """D3D-style LH perspective, clip z in [0,1] (reference `matrix.cu:342-357`).

    ``fovh`` is the *vertical* field of view in radians (the reference names it
    fovh but uses it as y_scale = 1/tan(fov/2)). Degenerate inputs produce an
    INFINITY-filled matrix like the reference.
    """
    aspect_ratio = jnp.asarray(aspect_ratio, jnp.float32)
    fovh = jnp.asarray(fovh, jnp.float32)
    znear = jnp.asarray(znear, jnp.float32)
    zfar = jnp.asarray(zfar, jnp.float32)
    y_scale = 1.0 / jnp.tan(fovh * 0.5)
    x_scale = y_scale / aspect_ratio
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(x_scale)
    m = m.at[1, 1].set(y_scale)
    m = m.at[2, 2].set(zfar / (zfar - znear))
    m = m.at[2, 3].set(1.0)
    m = m.at[3, 2].set(-znear * zfar / (zfar - znear))
    bad = (znear < 0.0) | (zfar < 0.0) | (jnp.abs(znear - zfar) < 1e-5)
    return jnp.where(bad, jnp.full((4, 4), jnp.inf, jnp.float32), m)


def orthographic(aspect_ratio, znear, zfar):
    """D3D-style orthographic, 2 world units tall (reference `matrix.cu:325-341`)."""
    aspect_ratio = jnp.asarray(aspect_ratio, jnp.float32)
    znear = jnp.asarray(znear, jnp.float32)
    zfar = jnp.asarray(zfar, jnp.float32)
    height = 2.0
    width = aspect_ratio * height
    m = jnp.zeros((4, 4), jnp.float32)
    m = m.at[0, 0].set(2.0 / width)
    m = m.at[1, 1].set(2.0 / height)
    m = m.at[2, 2].set(1.0 / (zfar - znear))
    m = m.at[3, 3].set(1.0)
    m = m.at[3, 2].set(znear / (znear - zfar))
    bad = (znear < 0.0) | (zfar < 0.0) | (jnp.abs(znear - zfar) < 1e-5)
    return jnp.where(bad, jnp.full((4, 4), jnp.inf, jnp.float32), m)


# ---------------------------------------------------------------------------
# Matrix application / derived matrices
# ---------------------------------------------------------------------------


def inverse(m):
    """4x4 inverse (reference uses adjugate expansion, `matrix.cu:141-271`).

    Singular matrices (|det| < 1e-5, the literal 0.00001f at `matrix.cu:143`)
    return an INFINITY-filled matrix — the reference contract at
    `matrix.cu:141-145`. The input is substituted with identity on the
    singular branch before `linalg.inv` so the unselected branch never
    produces NaNs that would poison `where`'s backward pass.
    """
    det = jnp.linalg.det(m)
    bad = jnp.abs(det) < 1e-5
    eye = jnp.broadcast_to(jnp.eye(m.shape[-1], dtype=m.dtype), m.shape)
    safe = jnp.where(bad[..., None, None], eye, m)
    inv = jnp.linalg.inv(safe)
    return jnp.where(bad[..., None, None], jnp.full_like(m, jnp.inf), inv)


def determinant(m):
    return jnp.linalg.det(m)


def transform_points(p, m):
    """Transform (...,3) points by (...,4,4): w=1, returns (...,3) without w-divide.

    Matches ``iqvec::transform(m, usage::POINT)`` (reference `vector.h:371-383`)
    for affine matrices, where w stays 1.
    """
    xyz = matmul(p, m[..., :3, :3]) + m[..., 3, :3]
    return xyz


def transform_points_h(p, m):
    """Homogeneous transform of (...,3) points: returns (xyz, w) WITHOUT divide."""
    xyz = matmul(p, m[..., :3, :3]) + m[..., 3, :3]
    w = matmul(p, m[..., :3, 3:4]) + m[..., 3, 3:4]
    return xyz, w[..., 0]


def project_points(p, m):
    """Homogeneous transform + w-divide (the rasterizer clip→NDC step)."""
    xyz, w = transform_points_h(p, m)
    return xyz / w[..., None], w


def transform_dirs(d, m):
    """Transform (...,3) directions by (...,4,4) with w=0."""
    return matmul(d, m[..., :3, :3])


def normal_matrix(m):
    """3x3 normal matrix N = inv(M3x3).T applied as row-vector ``n @ N``.

    Equivalent to the reference's two spellings:
      * path tracer: ``load3x3(transform.store3x3().transpose().inverse())``
        applied as a row-vector transform (`path_tracer.cu:260,268-270`), and
      * raster cbuffer: ``tr.store3x3().inverse().transposed()`` consumed by
        HLSL ``mul(normal_mat, norm)`` (`shader.cu:48-53`, `vertex_shader.hlsl`).
    Conscious fix vs the reference: ``mat3x3::inversed`` returns an
    INFINITY-filled matrix when |det| < 1e-5 (`matrix.cu:459-463`), which
    silently breaks normals for legitimately small uniform scales (a 1e-2
    scale already has det 1e-6). Here small-but-nonsingular scales invert
    exactly; truly singular inputs produce LAPACK inf/nan garbage either
    way. The 4x4 `inverse` above keeps the reference contract (it feeds
    camera math, where the reference relies on it).
    """
    m3 = m[..., :3, :3]
    return jnp.swapaxes(jnp.linalg.inv(m3), -1, -2)


def transform_normals(n, m):
    """Transform (...,3) normals by the 4x4 model matrix's normal matrix."""
    return matmul(n, normal_matrix(m))
