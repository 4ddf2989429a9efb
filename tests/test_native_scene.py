"""Native C++ scene core vs the Python scene graph (must agree exactly)."""

import math
import shutil

import numpy as np
import pytest

from ptre.models import demo, mesh as mg

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None and shutil.which("make") is None,
    reason="no C++ toolchain",
)


@pytest.fixture(scope="module")
def native():
    from ptre.models import native_scene

    native_scene.build_library()
    return native_scene


def _native_demo(native, segments=8, rings=4):
    ns = native.NativeScene()
    assert ns.add_mesh_tri("default")
    assert ns.add_mesh_cube("cube")
    assert ns.add_mesh_uv_sphere("sphere", False, segments, rings)
    assert ns.add_model("ground", "sphere")
    ns.set_transforms("ground", 10.0, (math.pi / 2, 0.0, 0.0), (0.0, -10.0, 0.0))
    assert ns.add_model("sph", "sphere")
    ns.set_transforms("sph", 0.5, 0.0, (0.0, 0.5, 0.0))
    assert ns.add_model("wall", "cube")
    ns.set_transforms("wall", 1.0, 0.0, (1.0, 0.5, 0.0))
    return ns


def _assert_packets_equal(a, b):
    assert a.num_triangles == b.num_triangles
    assert a.num_spheres == b.num_spheres
    assert a.num_drawcalls == b.num_drawcalls
    for f in (
        "tri_v0", "tri_v1", "tri_v2", "tri_n0", "tri_n1", "tri_n2",
        "tri_dc", "tri_mat", "tri_valid", "transforms",
        "sph_center", "sph_radius", "sph_mat", "sph_valid",
        "mat_kind", "mat_albedo", "mat_param",
    ):
        np.testing.assert_allclose(
            np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
            atol=1e-6, err_msg=f,
        )


def test_mesh_generators_match_python(native):
    ns = native.NativeScene()
    ns.add_mesh_tri("t")
    ns.add_mesh_quad("q")
    ns.add_mesh_cube("c")
    ns.add_mesh_reg_polygon("p", 7)
    ns.add_mesh_uv_sphere("s", False, 12, 6)
    ns.add_mesh_uv_sphere("sf", True, 12, 6)  # flat-shaded variant
    ref = {
        "t": mg.tri(), "q": mg.quad(), "c": mg.cube(),
        "p": mg.reg_polygon(7), "s": mg.uv_sphere(False, 12, 6),
        "sf": mg.uv_sphere(True, 12, 6),
    }
    for name, mesh in ref.items():
        pos, nrm, idx, ty = ns.get_mesh_arrays(name)
        np.testing.assert_allclose(pos, mesh.positions, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(nrm, mesh.normals, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(idx, mesh.indices, err_msg=name)
        assert ty == mesh.mesh_type


def test_demo_packet_matches_python(native):
    py = demo.reference_demo_scene(8, 4).build_packet(tri_pad=8, sph_pad=4)
    nat = _native_demo(native).build_packet(tri_pad=8, sph_pad=4)
    _assert_packets_equal(nat, py)


def test_raster_packet_matches_python(native):
    py = demo.reference_demo_scene(8, 4).build_packet(spheres_as_triangles=True)
    nat = _native_demo(native).build_packet(spheres_as_triangles=True)
    _assert_packets_equal(nat, py)


def test_crud_semantics(native):
    ns = native.NativeScene()
    assert ns.add_mesh_cube("m")
    assert not ns.add_mesh_tri("m")  # duplicate silently refused
    assert ns.add_model("a", "m")
    with pytest.raises(Exception):
        ns.add_model("b", "missing")
    assert not ns.delete_mesh("m")  # still referenced
    assert ns.rename_model("a", "z")
    assert ns.delete_model("z")
    assert ns.delete_mesh("m")
    assert ns.modified()
    # modified flag cleared by build
    ns.add_mesh_tri("t")
    ns.add_model("x", "t")
    ns.build_packet(tri_pad=8)
    assert not ns.modified()
    ns.set_transforms("x", 2.0, 0.0, 0.0)
    assert ns.modified()


def test_raw_mesh_and_material(native):
    ns = native.NativeScene()
    m = mg.uv_sphere(False, 6, 4, mg.MeshType.TRIANGLES)
    assert ns.add_mesh_raw("ball", m.positions, m.normals, m.indices)
    assert ns.add_model("b", "ball")
    from ptre.models.scene import Material, MaterialKind

    gold = ns.add_material(Material(MaterialKind.OREN_NAYAR, (0.9, 0.7, 0.2), 0.3))
    assert ns.set_model_material("b", gold)
    pkt = ns.build_packet(tri_pad=8)
    assert pkt.num_triangles == m.num_triangles
    assert np.all(np.asarray(pkt.tri_mat[: pkt.num_triangles]) == gold)


def test_native_packet_renders(native):
    """The native-built packet feeds the JAX path tracer unchanged."""
    import jax.numpy as jnp

    from ptre.ops import camera as cam_ops, rng
    from ptre.render import pathtracer as pt
    from ptre.utils.config import RenderConfig

    nat = _native_demo(native).build_packet()
    py = demo.reference_demo_scene(8, 4).build_packet()
    cam = cam_ops.Camera.create(width=16, height=16)
    cfg = RenderConfig(width=16, height=16)
    i_nat = pt.sample_image(rng.key_for(3), nat, cam, cfg)
    i_py = pt.sample_image(rng.key_for(3), py, cam, cfg)
    np.testing.assert_allclose(np.asarray(i_nat), np.asarray(i_py), atol=1e-6)
