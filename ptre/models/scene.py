"""Scene graph + HBM-resident SoA ScenePacket.

JAX equivalent of `IoniqRE/scene.{h,cu}` + `IoniqRE/model.{h,cu}`:

* ``Scene`` is the host-side graph: name→mesh and name→model maps with CRUD
  (add/rename/delete mesh & model, change_model_mesh — `scene.cu:15-102`),
  models iterated sorted by mesh name with insertion-order tie-break
  (`scene.h:58-68`), and a ``modified`` flag gating packet rebuild
  (`scene.h:96`).
* ``ScenePacket`` replaces the reference's pointer-patched gpu_packet deep
  copy (`scene.cu:104-264`) with a padded, static-shape SoA pytree that lives
  in HBM as a jitted-function argument: per-triangle gathered object-space
  vertices/normals, a per-drawcall transform stack (differentiable), analytic
  sphere (center, radius) arrays, and a differentiable material table.

The material table lifts the reference's in-kernel hard-coded materials
(`path_tracer.cu:248-249`: every triangle → emissive(white, 10), every sphere
→ oren_nayar(0.5 gray, sigma=1)) into assignable per-model materials whose
defaults reproduce the reference look exactly — fulfilling the reference's own
"add a material system" TODO (`application.cu:36-37`).

Sphere models ignore rotation and non-uniform scale: radius = scale.x and
center = translation, exactly like `scene.cu:176-177`.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ptre.models.mesh import Mesh, MeshType
from ptre.ops import vecmat as vm
from ptre.utils.errors import SceneError
from ptre.utils import pytree


class MaterialKind(enum.IntEnum):
    OREN_NAYAR = 0
    EMISSIVE = 1


@dataclasses.dataclass
class Material:
    """Host-side material: albedo + one scalar parameter.

    param = roughness sigma (clamped to [0,1] at eval) for OREN_NAYAR
    (`material.h:25-30`), or emission strength for EMISSIVE (`material.h`).
    """

    kind: MaterialKind
    albedo: Tuple[float, float, float]
    param: float


#: default sphere material (reference `path_tracer.cu:248`)
DEFAULT_OREN_NAYAR = Material(MaterialKind.OREN_NAYAR, (0.5, 0.5, 0.5), 1.0)
#: default triangle-mesh material (reference `path_tracer.cu:249`)
DEFAULT_EMISSIVE = Material(MaterialKind.EMISSIVE, (1.0, 1.0, 1.0), 10.0)


@dataclasses.dataclass
class Model:
    """A scene instance: mesh reference + TRS (reference `model.{h,cu}`).

    ``transform = S @ Rx @ Ry @ Rz @ T`` (`model.cu:11-18`), cached on set.
    ``material`` indexes the scene material table; None selects the
    type-default (sphere→0, triangles→1) like the reference hard-coding.
    """

    mesh_name: str = "default"
    scale: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    rotation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    translation: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    material: Optional[int] = None
    #: owning scene's dirty callback, set by Scene.add_model; mutation marks
    #: the scene modified like the reference's setters (`scene.cu:49`) — the
    #: flag is NOT set on mere reads (`scene::get_model` is a const lookup)
    _on_mutate: Optional[object] = dataclasses.field(
        default=None, repr=False, compare=False)

    def set_transforms(self, scale=1.0, rotation=0.0, translation=0.0):
        self.scale = _as3(scale)
        self.rotation = _as3(rotation)
        self.translation = _as3(translation)
        if self._on_mutate is not None:
            self._on_mutate()

    def set_material(self, material: Optional[int]):
        self.material = material
        if self._on_mutate is not None:
            self._on_mutate()

    def transform_matrix(self) -> np.ndarray:
        s = np.diag(list(self.scale) + [1.0]).astype(np.float32)
        rx, ry, rz = self.rotation
        r = _np_rot_x(rx) @ _np_rot_y(ry) @ _np_rot_z(rz)
        t = np.eye(4, dtype=np.float32)
        t[3, :3] = self.translation
        return (s @ r @ t).astype(np.float32)


def _as3(v) -> Tuple[float, float, float]:
    if np.isscalar(v):
        return (float(v), float(v), float(v))
    v = tuple(float(x) for x in np.asarray(v).reshape(-1)[:3])
    return v


def _np_rot_x(a):
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2], m[2, 1], m[2, 2] = c, s, -s, c
    return m


def _np_rot_y(a):
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 2], m[2, 0], m[2, 2] = c, -s, s, c
    return m


def _np_rot_z(a):
    c, s = math.cos(a), math.sin(a)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1], m[1, 0], m[1, 1] = c, s, -s, c
    return m


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


@pytree.dataclass
class ScenePacket:
    """Padded static-shape SoA scene, resident in HBM across frames.

    Triangles are flattened over all TRIANGLES-type drawcalls with their
    object-space vertices gathered per corner; ``tri_dc`` maps each triangle
    to its drawcall's row in ``transforms`` so world-space transforms (and
    their gradients) are applied once per frame instead of per ray per bounce
    (fixing the reference hot-loop pathology at `path_tracer.cu:265-270`
    while producing identical images).
    """

    # triangles (T padded)
    tri_v0: jnp.ndarray  # (T, 3) object space
    tri_v1: jnp.ndarray
    tri_v2: jnp.ndarray
    tri_n0: jnp.ndarray
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_dc: jnp.ndarray  # (T,) int32 → transforms row
    tri_mat: jnp.ndarray  # (T,) int32 → material row
    tri_valid: jnp.ndarray  # (T,) bool
    # per-drawcall transform stack (D padded)
    transforms: jnp.ndarray  # (D, 4, 4)
    # analytic spheres (S padded)
    sph_center: jnp.ndarray  # (S, 3)
    sph_radius: jnp.ndarray  # (S,)
    sph_mat: jnp.ndarray  # (S,) int32
    sph_valid: jnp.ndarray  # (S,) bool
    # material table (M padded)
    mat_kind: jnp.ndarray  # (M,) int32 MaterialKind
    mat_albedo: jnp.ndarray  # (M, 3)
    mat_param: jnp.ndarray  # (M,)
    # sky gradient endpoints (`path_tracer.cu:307-316`) — traced LEAVES so
    # the environment is a differentiable/learnable parameter like the
    # material table (the reference hard-codes them in-kernel)
    sky_bottom: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.array([1.0, 1.0, 1.0], jnp.float32))
    sky_top: jnp.ndarray = dataclasses.field(
        default_factory=lambda: jnp.array([0.5, 0.7, 1.0], jnp.float32))
    # true (unpadded) counts — static aux data; changing them recompiles,
    # mirroring the reference's modified-flag packet rebuild (`scene.h:96`)
    num_triangles: int = pytree.static_field(default=0)
    num_spheres: int = pytree.static_field(default=0)
    num_drawcalls: int = pytree.static_field(default=0)
    num_materials: int = pytree.static_field(default=0)

    def world_triangles(self):
        """World-space triangle vertices+normals: applied once per frame.

        Vertices use the drawcall transform (POINT), normals its
        inverse-transpose 3x3 (DIRECTION) then renormalize at interpolation
        time — matching `path_tracer.cu:257-282` semantics.
        """
        tf = self.transforms[self.tri_dc]  # (T, 4, 4)
        nm = vm.normal_matrix(tf)  # (T, 3, 3)
        v0 = _rowvec(self.tri_v0, tf)
        v1 = _rowvec(self.tri_v1, tf)
        v2 = _rowvec(self.tri_v2, tf)
        n0 = vm.einsum("ti,tij->tj", self.tri_n0, nm)
        n1 = vm.einsum("ti,tij->tj", self.tri_n1, nm)
        n2 = vm.einsum("ti,tij->tj", self.tri_n2, nm)
        # pinned as remat residuals — O(T) floats; see ops/gradsafe.py
        from ptre.ops import gradsafe

        return tuple(gradsafe.remat_pin(x) for x in (v0, v1, v2, n0, n1, n2))


def _rowvec(p, tf):
    return vm.einsum("ti,tij->tj", p, tf[:, :3, :3]) + tf[:, 3, :3]


class Scene:
    """Mutable host-side scene graph (reference `scene.{h,cu}` CRUD surface)."""

    def __init__(self):
        self._meshes: Dict[str, Mesh] = {}
        self._models: Dict[str, Model] = {}
        self._model_order: Dict[str, int] = {}  # insertion-order tie-break
        self._materials: List[Material] = [DEFAULT_OREN_NAYAR, DEFAULT_EMISSIVE]
        self._sky_bottom = (1.0, 1.0, 1.0)  # `path_tracer.cu:309-311`
        self._sky_top = (0.5, 0.7, 1.0)
        self._next_order = 0
        self._modified = True

    def set_sky(self, bottom, top):
        """Set the sky gradient endpoints (reference hard-codes white →
        (0.5, 0.7, 1.0) in-kernel, `path_tracer.cu:307-316`)."""
        self._sky_bottom = tuple(float(x) for x in bottom)
        self._sky_top = tuple(float(x) for x in top)
        self._modified = True

    # -- mesh CRUD (`scene.cu:15-45`) --------------------------------------
    def add_mesh(self, name: str, m: Mesh) -> bool:
        if name in self._meshes:
            return False  # reference silently refuses duplicate insert
        self._meshes[name] = m
        self._modified = True
        return True

    def rename_mesh(self, old: str, new: str):
        if old not in self._meshes or new in self._meshes:
            return
        self._meshes[new] = self._meshes.pop(old)
        for mdl in self._models.values():
            if mdl.mesh_name == old:
                mdl.mesh_name = new
        self._modified = True

    def delete_mesh(self, name: str):
        if name not in self._meshes:
            return
        in_use = [mn for mn, mdl in self._models.items() if mdl.mesh_name == name]
        if in_use:
            raise SceneError(f"mesh '{name}' still referenced by models {in_use}")
        del self._meshes[name]
        self._modified = True

    def get_mesh(self, name: str) -> Mesh:
        return self._meshes[name]

    @property
    def mesh_names(self) -> List[str]:
        return sorted(self._meshes)

    # -- model CRUD (`scene.cu:47-102`) ------------------------------------
    def add_model(self, name: str, m: Model) -> bool:
        if name in self._models:
            return False
        if m.mesh_name not in self._meshes:
            raise SceneError(f"model '{name}' references unknown mesh '{m.mesh_name}'")
        self._models[name] = m
        m._on_mutate = self._mark_modified
        self._model_order[name] = self._next_order
        self._next_order += 1
        self._modified = True
        return True

    def _mark_modified(self):
        self._modified = True

    def rename_model(self, old: str, new: str):
        if old not in self._models or new in self._models:
            return
        self._models[new] = self._models.pop(old)
        self._model_order[new] = self._model_order.pop(old)
        self._modified = True

    def delete_model(self, name: str):
        if name in self._models:
            del self._models[name]
            del self._model_order[name]
            self._modified = True

    def get_model(self, name: str) -> Model:
        """Read access does NOT dirty the scene (reference sets m_modified
        only on actual mutation, `scene.cu:49`); Model setters call back via
        ``_on_mutate`` instead, so TRS edits still trigger a packet rebuild."""
        return self._models[name]

    def change_model_mesh(self, model_name: str, new_mesh_name: str):
        if new_mesh_name not in self._meshes:
            raise SceneError(f"unknown mesh '{new_mesh_name}'")
        self._models[model_name].mesh_name = new_mesh_name
        self._modified = True

    # -- materials ----------------------------------------------------------
    def add_material(self, m: Material) -> int:
        self._materials.append(m)
        self._modified = True
        return len(self._materials) - 1

    def set_model_material(self, model_name: str, material_id: int):
        if not (0 <= material_id < len(self._materials)):
            raise SceneError(f"material id {material_id} out of range")
        self._models[model_name].material = material_id
        self._modified = True

    @property
    def materials(self) -> List[Material]:
        return list(self._materials)

    def modified(self) -> bool:
        return self._modified

    def sorted_models(self) -> List[Tuple[str, Model]]:
        """Models sorted by mesh name, insertion-order tie-break (`scene.h:58-68`)."""
        return sorted(
            self._models.items(),
            key=lambda kv: (kv[1].mesh_name, self._model_order[kv[0]]),
        )

    # -- packet build (`scene.cu:104-236`) ----------------------------------
    def build_packet(
        self,
        tri_pad: int = 128,
        sph_pad: int = 8,
        spheres_as_triangles: bool = False,
    ) -> ScenePacket:
        """Flatten the scene into a padded SoA ScenePacket pytree.

        Walks models sorted by mesh name exactly like `scene.cu:156-181`:
        TRIANGLES models become a (transform, gathered-triangle) drawcall;
        SPHERES models become analytic spheres with radius = scale.x and
        center = translation (`scene.cu:176-177`). Clears the modified flag
        (`scene.cu:112`).

        ``spheres_as_triangles=True`` instead emits every model's true mesh
        geometry as triangles — the rasterizer's view of the scene, which
        draws all meshes regardless of type (`rasterizer.cu:157-169`).
        """
        self._modified = False

        tv0, tv1, tv2, tn0, tn1, tn2 = [], [], [], [], [], []
        tdc, tmat = [], []
        transforms = []
        sph_c, sph_r, sph_m = [], [], []

        for _, mdl in self.sorted_models():
            mesh = self._meshes[mdl.mesh_name]
            if mesh.mesh_type == MeshType.SPHERES and not spheres_as_triangles:
                sph_c.append(mdl.translation)
                sph_r.append(mdl.scale[0])
                sph_m.append(
                    mdl.material if mdl.material is not None else int(MaterialKind.OREN_NAYAR)
                )
            else:
                dc = len(transforms)
                transforms.append(mdl.transform_matrix())
                idx = mesh.indices.reshape(-1, 3)
                tv0.append(mesh.positions[idx[:, 0]])
                tv1.append(mesh.positions[idx[:, 1]])
                tv2.append(mesh.positions[idx[:, 2]])
                tn0.append(mesh.normals[idx[:, 0]])
                tn1.append(mesh.normals[idx[:, 1]])
                tn2.append(mesh.normals[idx[:, 2]])
                ntri = idx.shape[0]
                tdc.append(np.full(ntri, dc, np.int32))
                mat = mdl.material if mdl.material is not None else int(MaterialKind.EMISSIVE)
                tmat.append(np.full(ntri, mat, np.int32))

        num_tris = sum(a.shape[0] for a in tv0)
        num_sph = len(sph_c)
        num_dc = len(transforms)
        t_cap = _round_up(num_tris, tri_pad)
        s_cap = _round_up(num_sph, sph_pad)
        d_cap = max(num_dc, 1)

        def cat_pad(parts, cap, dim=3):
            if parts:
                a = np.concatenate([np.asarray(p, np.float32).reshape(-1, dim) for p in parts])
            else:
                a = np.zeros((0, dim), np.float32)
            out = np.zeros((cap, dim), np.float32)
            out[: a.shape[0]] = a
            return out

        def cat_pad_i(parts, cap):
            a = np.concatenate(parts) if parts else np.zeros((0,), np.int32)
            out = np.zeros((cap,), np.int32)
            out[: a.shape[0]] = a
            return out

        tf = np.stack(transforms) if transforms else np.eye(4, dtype=np.float32)[None]
        if tf.shape[0] < d_cap:
            tf = np.concatenate([tf, np.broadcast_to(np.eye(4, np.float32), (d_cap - tf.shape[0], 4, 4))])

        sc = np.zeros((s_cap, 3), np.float32)
        sr = np.ones((s_cap,), np.float32)  # pad radius 1 to avoid 0-div in normals
        sm = np.zeros((s_cap,), np.int32)
        if num_sph:
            sc[:num_sph] = np.asarray(sph_c, np.float32)
            sr[:num_sph] = np.asarray(sph_r, np.float32)
            sm[:num_sph] = np.asarray(sph_m, np.int32)

        mats = self._materials
        mat_kind = np.asarray([int(m.kind) for m in mats], np.int32)
        mat_albedo = np.asarray([m.albedo for m in mats], np.float32)
        mat_param = np.asarray([m.param for m in mats], np.float32)

        tri_valid = np.arange(t_cap) < num_tris
        sph_valid = np.arange(s_cap) < num_sph

        return ScenePacket(
            tri_v0=jnp.asarray(cat_pad(tv0, t_cap)),
            tri_v1=jnp.asarray(cat_pad(tv1, t_cap)),
            tri_v2=jnp.asarray(cat_pad(tv2, t_cap)),
            tri_n0=jnp.asarray(cat_pad(tn0, t_cap)),
            tri_n1=jnp.asarray(cat_pad(tn1, t_cap)),
            tri_n2=jnp.asarray(cat_pad(tn2, t_cap)),
            tri_dc=jnp.asarray(cat_pad_i(tdc, t_cap)),
            tri_mat=jnp.asarray(cat_pad_i(tmat, t_cap)),
            tri_valid=jnp.asarray(tri_valid),
            transforms=jnp.asarray(tf),
            sph_center=jnp.asarray(sc),
            sph_radius=jnp.asarray(sr),
            sph_mat=jnp.asarray(sm),
            sph_valid=jnp.asarray(sph_valid),
            mat_kind=jnp.asarray(mat_kind),
            mat_albedo=jnp.asarray(mat_albedo),
            mat_param=jnp.asarray(mat_param),
            sky_bottom=jnp.asarray(self._sky_bottom, jnp.float32),
            sky_top=jnp.asarray(self._sky_top, jnp.float32),
            num_triangles=num_tris,
            num_spheres=num_sph,
            num_drawcalls=num_dc,
            num_materials=len(mats),
        )

    # -- rasterizer view of the scene ---------------------------------------
    def raster_drawcalls(self):
        """Per-model (mesh, transform) list in sorted order, mesh bind reuse
        left to the caller (reference `rasterizer.cu:157-169`). SPHERES-type
        meshes rasterize their true geometry, like the reference rasterizer
        which draws every model's mesh regardless of type."""
        out = []
        for name, mdl in self.sorted_models():
            out.append((name, self._meshes[mdl.mesh_name], mdl.transform_matrix()))
        return out
