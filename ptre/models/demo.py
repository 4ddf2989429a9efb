"""Demo scenes.

The reference builds one hard-coded demo scene at startup
(`application.cu:25-34`): meshes "default" (tri), "cube", "sphere"
(uv_sphere(false, 128, 64), SPHERES type); models "ground" (sphere scaled 10,
rotated pi/2 about x, at (0,-10,0)), "sph" (sphere scaled 0.5 at (0,0.5,0)),
"wall" (cube at (1,0.5,0)). Sphere models path-trace analytically with radius
= scale.x, center = translation; the cube's 12 triangles take the mesh path.
"""

from __future__ import annotations

import math

from ptre.models import mesh as mesh_gen
from ptre.models.scene import Model, Scene


def reference_demo_scene(sphere_segments: int = 128, sphere_rings: int = 64) -> Scene:
    """The exact reference demo scene (`application.cu:25-34`)."""
    scn = Scene()
    scn.add_mesh("default", mesh_gen.tri())
    scn.add_mesh("cube", mesh_gen.cube())
    scn.add_mesh("sphere", mesh_gen.uv_sphere(False, sphere_segments, sphere_rings))

    scn.add_model("ground", Model("sphere"))
    scn.get_model("ground").set_transforms(
        10.0, (math.pi / 2.0, 0.0, 0.0), (0.0, -10.0, 0.0)
    )
    scn.add_model("sph", Model("sphere"))
    scn.get_model("sph").set_transforms(0.5, 0.0, (0.0, 0.5, 0.0))
    scn.add_model("wall", Model("cube"))
    scn.get_model("wall").set_transforms(1.0, 0.0, (1.0, 0.5, 0.0))
    return scn


def sphere_light_scene() -> Scene:
    """BASELINE config 1: one analytic sphere + emissive quad light."""
    scn = Scene()
    scn.add_mesh("sphere", mesh_gen.uv_sphere(False, 16, 8))
    scn.add_mesh("light", mesh_gen.quad())

    scn.add_model("ball", Model("sphere"))
    scn.get_model("ball").set_transforms(1.0, 0.0, (0.0, 0.5, 1.0))
    scn.add_model("lamp", Model("light"))
    scn.get_model("lamp").set_transforms(
        2.0, (math.pi / 2.0, 0.0, 0.0), (0.0, 3.0, 1.0)
    )
    return scn


def cornell_spheres_scene() -> Scene:
    """BASELINE config 2: multi-sphere Cornell-style box from analytic spheres."""
    scn = Scene()
    scn.add_mesh("sphere", mesh_gen.uv_sphere(False, 16, 8))
    scn.add_mesh("light", mesh_gen.quad())
    scn.add_mesh("wall", mesh_gen.quad())

    # huge spheres as walls/floor (classic smallpt trick)
    for name, r, pos in [
        ("floor", 1000.0, (0.0, -1000.0, 0.0)),
        ("left", 1000.0, (-1003.0, 1.0, 0.0)),
        ("right", 1000.0, (1003.0, 1.0, 0.0)),
        ("back", 1000.0, (0.0, 1.0, 1004.0)),
    ]:
        scn.add_model(name, Model("sphere"))
        scn.get_model(name).set_transforms(r, 0.0, pos)
    for name, r, pos in [
        ("ball_a", 0.7, (-1.0, 0.7, 1.0)),
        ("ball_b", 0.5, (0.9, 0.5, 0.2)),
    ]:
        scn.add_model(name, Model("sphere"))
        scn.get_model(name).set_transforms(r, 0.0, pos)
    scn.add_model("lamp", Model("light"))
    scn.get_model("lamp").set_transforms(
        2.0, (math.pi / 2.0, 0.0, 0.0), (0.0, 4.0, 0.5)
    )
    return scn


def config3_scene(flat: bool = False, segments: int = 128,
                  rings: int = 64, diffuse: bool = False) -> Scene:
    """BASELINE config 3: a uv-sphere forced to TRIANGLES over an analytic
    ground — the reference's known scaling cliff (`path_tracer.cu:263-282`;
    README: "keep the vertex count low"). ``flat=True`` uses the
    flat-shaded mesh variant (per-face normals — the reference's
    `mesh.cu:198` TODO, implemented here); ``diffuse=True`` overrides the
    reference's emissive triangle default with the Oren-Nayar material so
    the normals actually shade (the flat/smooth goldens need this — an
    emissive surface renders identically under either normal set)."""
    scn = Scene()
    scn.add_mesh("ball", mesh_gen.uv_sphere(
        flat, segments, rings, mesh_type=mesh_gen.MeshType.TRIANGLES))
    scn.add_mesh("ground", mesh_gen.uv_sphere(False, 16, 8))
    scn.add_model("b", Model("ball"))
    scn.get_model("b").set_transforms(1.0, 0.0, (0.0, 0.5, 0.0))
    if diffuse:
        scn.get_model("b").set_material(0)
    scn.add_model("g", Model("ground"))
    scn.get_model("g").set_transforms(10.0, 0.0, (0.0, -10.0, 0.0))
    return scn


def config4_mixed_scene(segments: int = 128, rings: int = 64) -> Scene:
    """BASELINE config 4: mixed analytic-sphere + triangle-mesh scene —
    a diffuse triangle uv-sphere, a cube mesh, an analytic sphere and the
    analytic ground, exercising both primitive paths (and deep diffuse
    paths) in one differentiable frame."""
    scn = Scene()
    scn.add_mesh("ball", mesh_gen.uv_sphere(
        False, segments, rings, mesh_type=mesh_gen.MeshType.TRIANGLES))
    scn.add_mesh("cube", mesh_gen.cube())
    scn.add_mesh("sph", mesh_gen.uv_sphere(False, 16, 8))
    scn.add_model("b", Model("ball"))
    scn.get_model("b").set_transforms(1.0, 0.0, (-1.2, 0.5, 0.0))
    scn.get_model("b").set_material(0)  # diffuse: deep paths, like the demo
    scn.add_model("c", Model("cube"))
    scn.get_model("c").set_transforms(1.2, (0.0, 0.6, 0.0), (1.4, 0.2, 0.6))
    scn.add_model("s", Model("sph"))
    scn.get_model("s").set_transforms(0.7, 0.0, (0.2, 0.2, 1.8))
    scn.add_model("g", Model("sph"))
    scn.get_model("g").set_transforms(10.0, 0.0, (0.0, -10.0, 0.0))
    return scn
