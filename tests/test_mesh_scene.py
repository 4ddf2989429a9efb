"""Mesh generator topology + scene graph / ScenePacket tests."""

import math

import numpy as np
import pytest

from ptre.models import demo, mesh as mg
from ptre.models.scene import (
    DEFAULT_EMISSIVE, DEFAULT_OREN_NAYAR, Material, MaterialKind, Model, Scene,
)
from ptre.utils.errors import SceneError


def test_tri_quad_topology():
    t = mg.tri()
    assert t.num_vertices == 3 and t.num_triangles == 1
    q = mg.quad()
    assert q.num_vertices == 4 and q.num_triangles == 2
    np.testing.assert_array_equal(q.indices, [0, 3, 1, 1, 3, 2])


def test_reg_polygon_topology():
    for n in (3, 5, 8):
        p = mg.reg_polygon(n)
        assert p.num_vertices == n + 1  # center + ring (`mesh.cu:100-128`)
        assert p.num_triangles == n
        # ring vertices lie on radius 0.5
        r = np.linalg.norm(p.positions[1:, :2], axis=1)
        np.testing.assert_allclose(r, 0.5, atol=1e-6)
    # degenerate clamps to 3
    assert mg.reg_polygon(1).num_triangles == 3


def test_cube_topology():
    c = mg.cube()
    assert c.num_vertices == 24 and c.num_indices == 36  # `mesh.cu:130-186`
    # per-face normals are axis-aligned unit vectors
    np.testing.assert_allclose(np.abs(c.normals).sum(axis=1), 1.0)
    # all corners at ±0.5
    np.testing.assert_allclose(np.abs(c.positions), 0.5)
    # each face's vertices lie in the face plane of its normal
    for f in range(6):
        vs = c.positions[4 * f : 4 * f + 4]
        n = c.normals[4 * f]
        d = vs @ n
        np.testing.assert_allclose(d, 0.5, atol=1e-6)


def test_uv_sphere_topology():
    seg, rings = 8, 5
    s = mg.uv_sphere(False, seg, rings)
    # (rings-1) interior rings * segments + 2 poles (`mesh.cu:205-226`)
    assert s.num_vertices == (rings - 1) * seg + 2
    # quad bands: (rings-2)*segments*2 tris; caps: 2*segments tris
    assert s.num_triangles == (rings - 2) * seg * 2 + 2 * seg
    np.testing.assert_allclose(np.linalg.norm(s.positions, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(s.positions, s.normals)  # smooth normals = positions
    assert s.mesh_type == mg.MeshType.SPHERES  # default (`mesh.h:93`)
    assert s.indices.max() == s.num_vertices - 1
    # watertight: every edge shared by exactly 2 triangles
    idx = s.indices.reshape(-1, 3)
    edges = {}
    for a, b, c in idx:
        for e in ((a, b), (b, c), (c, a)):
            k = (min(e), max(e))
            edges[k] = edges.get(k, 0) + 1
    assert set(edges.values()) == {2}


def test_uv_sphere_flat():
    """flat=True (the reference's mesh.cu:198 TODO, implemented here):
    per-face outward normals, unshared vertices, same face count."""
    seg, rings = 8, 5
    smooth = mg.uv_sphere(False, seg, rings)
    s = mg.uv_sphere(True, seg, rings)
    assert s.num_triangles == smooth.num_triangles
    assert s.num_vertices == 3 * s.num_triangles  # fully unshared
    np.testing.assert_array_equal(s.indices, np.arange(s.num_vertices))
    idx = s.indices.reshape(-1, 3)
    tv = s.positions[idx]
    # the 3 normals of each face are identical and unit length
    fn = s.normals[idx]
    np.testing.assert_allclose(fn[:, 0], fn[:, 1])
    np.testing.assert_allclose(fn[:, 0], fn[:, 2])
    np.testing.assert_allclose(np.linalg.norm(fn[:, 0], axis=-1), 1.0, atol=1e-6)
    # normals point outward and match the geometric face normal
    geo = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
    geo /= np.maximum(np.linalg.norm(geo, axis=-1, keepdims=True), 1e-20)
    dots = np.einsum("fi,fi->f", fn[:, 0], geo)
    np.testing.assert_allclose(np.abs(dots), 1.0, atol=1e-5)
    assert np.all(np.einsum("fi,fi->f", fn[:, 0], tv.mean(axis=1)) > 0)


def test_scene_crud():
    scn = Scene()
    assert scn.add_mesh("m", mg.cube())
    assert not scn.add_mesh("m", mg.tri())  # silent duplicate refusal
    scn.add_model("a", Model("m"))
    with pytest.raises(SceneError):
        scn.add_model("bad", Model("missing"))
    with pytest.raises(SceneError):
        scn.delete_mesh("m")  # still referenced
    scn.rename_model("a", "b")
    assert "b" in dict(scn.sorted_models())
    scn.delete_model("b")
    scn.delete_mesh("m")
    assert scn.mesh_names == []


def test_modified_flag_gates_rebuild():
    scn = demo.reference_demo_scene(8, 4)
    assert scn.modified()
    scn.build_packet()
    assert not scn.modified()  # cleared like `scene.cu:112`
    scn.get_model("wall").set_transforms(1.0, 0.0, (2.0, 0.5, 0.0))
    assert scn.modified()


def test_packet_reference_demo_layout():
    scn = demo.reference_demo_scene(8, 4)
    pkt = scn.build_packet(tri_pad=8, sph_pad=4)
    # 2 sphere models (ground, sph), 1 triangle drawcall (cube wall)
    assert pkt.num_spheres == 2
    assert pkt.num_triangles == 12
    assert pkt.num_drawcalls == 1
    # sphere params: radius = scale.x, center = translation (`scene.cu:176-177`)
    c = np.asarray(pkt.sph_center[: pkt.num_spheres])
    r = np.asarray(pkt.sph_radius[: pkt.num_spheres])
    assert {(tuple(cc), rr) for cc, rr in zip(map(tuple, c), r)} == {
        ((0.0, -10.0, 0.0), 10.0),
        ((0.0, 0.5, 0.0), 0.5),
    }
    # default materials reproduce the reference hard-coding
    assert np.all(np.asarray(pkt.sph_mat[: pkt.num_spheres]) == int(MaterialKind.OREN_NAYAR))
    assert np.all(np.asarray(pkt.tri_mat[: pkt.num_triangles]) == int(MaterialKind.EMISSIVE))
    # padding is masked off
    assert np.asarray(pkt.tri_valid).sum() == 12
    assert np.asarray(pkt.sph_valid).sum() == 2
    # wall transform: translation (1, 0.5, 0) in row 3
    tf = np.asarray(pkt.transforms[0])
    np.testing.assert_allclose(tf[3, :3], [1.0, 0.5, 0.0])


def test_packet_world_triangles():
    scn = Scene()
    scn.add_mesh("cube", mg.cube())
    scn.add_model("c", Model("cube"))
    scn.get_model("c").set_transforms((2.0, 1.0, 1.0), 0.0, (10.0, 0.0, 0.0))
    pkt = scn.build_packet(tri_pad=8)
    v0, v1, v2, n0, n1, n2 = (np.asarray(a) for a in pkt.world_triangles())
    valid = np.asarray(pkt.tri_valid)
    # x extents scaled by 2 and shifted by 10
    xs = np.concatenate([v0[valid][:, 0], v1[valid][:, 0], v2[valid][:, 0]])
    np.testing.assert_allclose(sorted(set(np.round(xs, 4))), [9.0, 11.0])
    # +X face normals remain +x after non-uniform scale (inverse-transpose)
    on_px_face = (
        (np.abs(v0[:, 0] - 11.0) < 1e-4)
        & (np.abs(v1[:, 0] - 11.0) < 1e-4)
        & (np.abs(v2[:, 0] - 11.0) < 1e-4)
        & valid
    )
    assert on_px_face.sum() == 2  # two triangles on the +X face
    nx = n0[on_px_face]
    assert np.all(nx[:, 0] > 0)
    np.testing.assert_allclose(nx[:, 1:], 0.0, atol=1e-6)


def test_spheres_as_triangles_raster_view():
    scn = demo.reference_demo_scene(8, 4)
    pkt = scn.build_packet(spheres_as_triangles=True)
    sphere_tris = scn.get_mesh("sphere").num_triangles
    assert pkt.num_triangles == 12 + 2 * sphere_tris
    assert pkt.num_spheres == 0


def test_material_table():
    scn = demo.reference_demo_scene(8, 4)
    gold = scn.add_material(Material(MaterialKind.OREN_NAYAR, (0.9, 0.7, 0.2), 0.3))
    scn.set_model_material("wall", gold)
    pkt = scn.build_packet(tri_pad=8)
    assert pkt.num_materials == 3
    assert np.all(np.asarray(pkt.tri_mat[: pkt.num_triangles]) == gold)
    np.testing.assert_allclose(np.asarray(pkt.mat_albedo[gold]), [0.9, 0.7, 0.2])
    # defaults intact
    assert DEFAULT_OREN_NAYAR.param == 1.0 and DEFAULT_EMISSIVE.param == 10.0


def test_sorted_models_mesh_name_order():
    scn = Scene()
    scn.add_mesh("b_mesh", mg.tri())
    scn.add_mesh("a_mesh", mg.tri())
    scn.add_model("m1", Model("b_mesh"))
    scn.add_model("m2", Model("a_mesh"))
    scn.add_model("m3", Model("a_mesh"))
    names = [n for n, _ in scn.sorted_models()]
    assert names == ["m2", "m3", "m1"]  # mesh-name sort, insertion tie-break
