"""ctypes binding for the native C++ scene-graph runtime (native/scene_core.cpp).

`NativeScene` mirrors the Python `Scene` API but keeps the graph, mesh
generation and packet flattening in C++ — the framework's equivalent of the
reference keeping its whole runtime native. `build_packet()` returns the same
`ScenePacket` pytree the JAX compute path consumes, so the two scene backends
are interchangeable (and cross-checked in tests/test_native_scene.py).

The shared library is built on demand with `make` (g++ is part of the image);
pybind11 is unavailable here, hence the C ABI + ctypes.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess
from typing import List, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ptre.models.mesh import MeshType
from ptre.models.scene import (
    DEFAULT_EMISSIVE, DEFAULT_OREN_NAYAR, Material, MaterialKind, ScenePacket,
)
from ptre.utils.errors import SceneError

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libptre_scene.so")

_lib = None


def _f3(v):
    a = (C.c_float * 3)()
    vv = np.broadcast_to(np.asarray(v, np.float32).reshape(-1), (3,)) \
        if np.isscalar(v) or np.asarray(v).size == 1 else np.asarray(v, np.float32).reshape(3)
    for i in range(3):
        a[i] = float(vv[i])
    return a


def build_library(force: bool = False) -> str:
    """Compile native/libptre_scene.so if missing (or force)."""
    if force or not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-s"], cwd=_NATIVE_DIR, check=True)
    return _LIB_PATH


def load_library():
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL(build_library())
    lib.ptre_scene_create.restype = C.c_void_p
    for name, args in {
        "ptre_scene_destroy": [C.c_void_p],
        "ptre_scene_modified": [C.c_void_p],
        "ptre_scene_add_mesh_tri": [C.c_void_p, C.c_char_p],
        "ptre_scene_add_mesh_quad": [C.c_void_p, C.c_char_p],
        "ptre_scene_add_mesh_reg_polygon": [C.c_void_p, C.c_char_p, C.c_uint32],
        "ptre_scene_add_mesh_cube": [C.c_void_p, C.c_char_p],
        "ptre_scene_add_mesh_uv_sphere": [
            C.c_void_p, C.c_char_p, C.c_int, C.c_uint32, C.c_uint32, C.c_int32,
        ],
        "ptre_scene_add_mesh_raw": [
            C.c_void_p, C.c_char_p, C.c_void_p, C.c_void_p, C.c_uint32,
            C.c_void_p, C.c_uint32, C.c_int32,
        ],
        "ptre_scene_rename_mesh": [C.c_void_p, C.c_char_p, C.c_char_p],
        "ptre_scene_delete_mesh": [C.c_void_p, C.c_char_p],
        "ptre_scene_mesh_counts": [
            C.c_void_p, C.c_char_p, C.c_void_p, C.c_void_p, C.c_void_p,
        ],
        "ptre_scene_mesh_data": [
            C.c_void_p, C.c_char_p, C.c_void_p, C.c_void_p, C.c_void_p,
        ],
        "ptre_scene_add_model": [C.c_void_p, C.c_char_p, C.c_char_p],
        "ptre_scene_rename_model": [C.c_void_p, C.c_char_p, C.c_char_p],
        "ptre_scene_delete_model": [C.c_void_p, C.c_char_p],
        "ptre_scene_set_transforms": [
            C.c_void_p, C.c_char_p, C.c_void_p, C.c_void_p, C.c_void_p,
        ],
        "ptre_scene_set_model_material": [C.c_void_p, C.c_char_p, C.c_int32],
        "ptre_scene_change_model_mesh": [C.c_void_p, C.c_char_p, C.c_char_p],
        "ptre_scene_packet_counts": [
            C.c_void_p, C.c_int, C.c_void_p, C.c_void_p, C.c_void_p,
        ],
        "ptre_scene_build_packet": [C.c_void_p, C.c_int, C.c_int32, C.c_int32]
        + [C.c_void_p] * 12,
    }.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        if name not in ("ptre_scene_destroy", "ptre_scene_packet_counts"):
            fn.restype = C.c_int
    _lib = lib
    return lib


def _round_up(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


class NativeScene:
    """Scene graph backed by the C++ core; Python keeps only the material table."""

    def __init__(self):
        self._lib = load_library()
        self._h = C.c_void_p(self._lib.ptre_scene_create())
        self._materials: List[Material] = [DEFAULT_OREN_NAYAR, DEFAULT_EMISSIVE]

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.ptre_scene_destroy(self._h)
                self._h = None
        except Exception:
            pass

    # -- mesh CRUD -----------------------------------------------------------
    def add_mesh_tri(self, name: str) -> bool:
        return bool(self._lib.ptre_scene_add_mesh_tri(self._h, name.encode()))

    def add_mesh_quad(self, name: str) -> bool:
        return bool(self._lib.ptre_scene_add_mesh_quad(self._h, name.encode()))

    def add_mesh_reg_polygon(self, name: str, vertices: int) -> bool:
        return bool(
            self._lib.ptre_scene_add_mesh_reg_polygon(self._h, name.encode(), vertices)
        )

    def add_mesh_cube(self, name: str) -> bool:
        return bool(self._lib.ptre_scene_add_mesh_cube(self._h, name.encode()))

    def add_mesh_uv_sphere(
        self, name: str, flat=False, segments=32, rings=16,
        mesh_type: MeshType = MeshType.SPHERES,
    ) -> bool:
        return bool(
            self._lib.ptre_scene_add_mesh_uv_sphere(
                self._h, name.encode(), int(flat), segments, rings, int(mesh_type)
            )
        )

    def add_mesh_raw(self, name, positions, normals, indices,
                     mesh_type: MeshType = MeshType.TRIANGLES) -> bool:
        p = np.ascontiguousarray(positions, np.float32)
        n = np.ascontiguousarray(normals, np.float32)
        i = np.ascontiguousarray(indices, np.uint32)
        return bool(
            self._lib.ptre_scene_add_mesh_raw(
                self._h, name.encode(), p.ctypes.data, n.ctypes.data,
                p.shape[0], i.ctypes.data, i.shape[0], int(mesh_type),
            )
        )

    def rename_mesh(self, old: str, new: str) -> bool:
        return bool(self._lib.ptre_scene_rename_mesh(self._h, old.encode(), new.encode()))

    def delete_mesh(self, name: str) -> bool:
        return bool(self._lib.ptre_scene_delete_mesh(self._h, name.encode()))

    def get_mesh_arrays(self, name: str):
        nv, ni, ty = C.c_uint32(), C.c_uint32(), C.c_int32()
        if not self._lib.ptre_scene_mesh_counts(
            self._h, name.encode(), C.byref(nv), C.byref(ni), C.byref(ty)
        ):
            raise SceneError(f"unknown mesh '{name}'")
        pos = np.empty((nv.value, 3), np.float32)
        nrm = np.empty((nv.value, 3), np.float32)
        idx = np.empty((ni.value,), np.uint32)
        self._lib.ptre_scene_mesh_data(
            self._h, name.encode(), pos.ctypes.data, nrm.ctypes.data, idx.ctypes.data
        )
        return pos, nrm, idx, MeshType(ty.value)

    # -- model CRUD ----------------------------------------------------------
    def add_model(self, name: str, mesh_name: str) -> bool:
        ok = bool(self._lib.ptre_scene_add_model(self._h, name.encode(), mesh_name.encode()))
        if not ok and not self.has_mesh(mesh_name):
            raise SceneError(f"model '{name}' references unknown mesh '{mesh_name}'")
        return ok

    def has_mesh(self, name: str) -> bool:
        nv, ni, ty = C.c_uint32(), C.c_uint32(), C.c_int32()
        return bool(
            self._lib.ptre_scene_mesh_counts(
                self._h, name.encode(), C.byref(nv), C.byref(ni), C.byref(ty)
            )
        )

    def rename_model(self, old: str, new: str) -> bool:
        return bool(self._lib.ptre_scene_rename_model(self._h, old.encode(), new.encode()))

    def delete_model(self, name: str) -> bool:
        return bool(self._lib.ptre_scene_delete_model(self._h, name.encode()))

    def set_transforms(self, model: str, scale=1.0, rotation=0.0, translation=0.0) -> bool:
        return bool(
            self._lib.ptre_scene_set_transforms(
                self._h, model.encode(), _f3(scale), _f3(rotation), _f3(translation)
            )
        )

    def change_model_mesh(self, model: str, mesh: str) -> bool:
        return bool(
            self._lib.ptre_scene_change_model_mesh(self._h, model.encode(), mesh.encode())
        )

    # -- materials (Python-side table, ids passed to C) ----------------------
    def add_material(self, m: Material) -> int:
        self._materials.append(m)
        return len(self._materials) - 1

    def set_model_material(self, model: str, material_id: int) -> bool:
        if not (0 <= material_id < len(self._materials)):
            raise SceneError(f"material id {material_id} out of range")
        return bool(
            self._lib.ptre_scene_set_model_material(self._h, model.encode(), material_id)
        )

    def modified(self) -> bool:
        return bool(self._lib.ptre_scene_modified(self._h))

    # -- packet --------------------------------------------------------------
    def build_packet(
        self, tri_pad: int = 128, sph_pad: int = 8,
        spheres_as_triangles: bool = False,
    ) -> ScenePacket:
        nt, ns, nd = C.c_uint32(), C.c_uint32(), C.c_uint32()
        self._lib.ptre_scene_packet_counts(
            self._h, int(spheres_as_triangles), C.byref(nt), C.byref(ns), C.byref(nd)
        )
        T, S, D = nt.value, ns.value, nd.value
        t_cap = _round_up(T, tri_pad)
        s_cap = _round_up(S, sph_pad)
        d_cap = max(D, 1)

        tv = [np.zeros((t_cap, 3), np.float32) for _ in range(6)]
        tri_dc = np.zeros((t_cap,), np.int32)
        tri_mat = np.zeros((t_cap,), np.int32)
        tf = np.tile(np.eye(4, dtype=np.float32).reshape(1, 16), (d_cap, 1))
        sc = np.zeros((s_cap, 3), np.float32)
        sr = np.ones((s_cap,), np.float32)
        sm = np.zeros((s_cap,), np.int32)

        self._lib.ptre_scene_build_packet(
            self._h, int(spheres_as_triangles),
            int(MaterialKind.EMISSIVE), int(MaterialKind.OREN_NAYAR),
            *(a.ctypes.data for a in tv),
            tri_dc.ctypes.data, tri_mat.ctypes.data, tf.ctypes.data,
            sc.ctypes.data, sr.ctypes.data, sm.ctypes.data,
        )

        mats = self._materials
        return ScenePacket(
            tri_v0=jnp.asarray(tv[0]), tri_v1=jnp.asarray(tv[1]),
            tri_v2=jnp.asarray(tv[2]), tri_n0=jnp.asarray(tv[3]),
            tri_n1=jnp.asarray(tv[4]), tri_n2=jnp.asarray(tv[5]),
            tri_dc=jnp.asarray(tri_dc), tri_mat=jnp.asarray(tri_mat),
            tri_valid=jnp.asarray(np.arange(t_cap) < T),
            transforms=jnp.asarray(tf.reshape(d_cap, 4, 4)),
            sph_center=jnp.asarray(sc), sph_radius=jnp.asarray(sr),
            sph_mat=jnp.asarray(sm),
            sph_valid=jnp.asarray(np.arange(s_cap) < S),
            mat_kind=jnp.asarray([int(m.kind) for m in mats], jnp.int32),
            mat_albedo=jnp.asarray([m.albedo for m in mats], jnp.float32),
            mat_param=jnp.asarray([m.param for m in mats], jnp.float32),
            num_triangles=T, num_spheres=S, num_drawcalls=D,
            num_materials=len(mats),
        )
