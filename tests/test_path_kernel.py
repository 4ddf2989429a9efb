"""The Triton path kernel (`ops.pallas.path_kernel`) and the forward route.

CPU tests run the kernel in the Pallas interpreter against the staged XLA
route on the same key (both draw identical random numbers); ``gpu`` tests
run the compiled kernel on the card (`python chip_smoke.py`).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ptre.models import demo
from ptre.models import mesh as mesh_gen
from ptre.models.scene import Model, Scene
from ptre.ops import camera as cam_ops, intersect, materials, rng
from ptre.ops.pallas import path_kernel
from ptre.parallel import sharding as sh
from ptre.render import pathtracer as pt
from ptre.render import train
from ptre.utils.config import RenderConfig


def _tri_only():
    scn = Scene()
    scn.add_mesh("ball", mesh_gen.uv_sphere(
        False, 8, 4, mesh_type=mesh_gen.MeshType.TRIANGLES))
    scn.add_mesh("cube", mesh_gen.cube())
    scn.add_model("b", Model("ball", material=0))
    scn.get_model("b").set_transforms(0.8, 0.0, (-0.5, 0.5, 0.0))
    scn.add_model("c", Model("cube"))  # emissive (reference default)
    scn.get_model("c").set_transforms(0.6, (0.0, 0.5, 0.0), (0.8, 0.3, 0.5))
    return scn


def _sph_only():
    scn = Scene()
    scn.add_mesh("s", mesh_gen.uv_sphere(False, 8, 4))
    scn.add_model("ground", Model("s"))
    scn.get_model("ground").set_transforms(10.0, 0.0, (0.0, -10.0, 0.0))
    scn.add_model("ball", Model("s"))
    scn.get_model("ball").set_transforms(0.5, 0.0, (0.0, 0.5, 0.0))
    return scn


SCENES = {
    "demo": lambda: demo.reference_demo_scene(8, 4),
    "tri": _tri_only,
    "sph": _sph_only,
    "empty": Scene,
    "config3": lambda: demo.config3_scene(segments=8, rings=4),
}

CASES = [  # (scene, W, H, max_depth, orthographic)
    ("demo", 16, 8, 5, False),    # 128 rays: one full block
    ("demo", 20, 13, 5, False),   # 260 rays: the last block is padded
    ("demo", 16, 8, 1, False),    # max_depth 1
    ("tri", 16, 12, 5, False),
    ("sph", 16, 12, 5, False),
    ("empty", 12, 10, 5, False),
    ("config3", 16, 12, 3, True),
]


def _staged_and_kernel(scene, W, H, max_depth, ortho, spp=1, frame=0,
                       init=0.0, seed=11):
    pkt = SCENES[scene]().build_packet()
    cam = cam_ops.Camera.create(
        width=W, height=H,
        projection=cam_ops.ORTHOGRAPHIC if ortho else cam_ops.PERSPECTIVE)
    cfg = RenderConfig(width=W, height=H, max_depth=max_depth)
    key = rng.key_for(seed)
    accum = pt.AccumState(
        linear=jnp.full((H, W, 3), init, jnp.float32),
        frame=jnp.asarray(frame, jnp.int32))
    ref = pt.staged_render_step(pkt, cam, accum, key, cfg, spp=spp)
    got = path_kernel.accumulate(key, pkt, cam, accum.linear.reshape(-1, 3),
                                 accum.frame, cfg, spp=spp, interpret=True)
    return np.asarray(got).reshape(H, W, 3), np.asarray(ref.linear)


@pytest.mark.parametrize("scene,W,H,max_depth,ortho", CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}-d{c[3]}"
                              + ("-ortho" if c[4] else "") for c in CASES])
def test_kernel_matches_staged_route(scene, W, H, max_depth, ortho):
    got, ref = _staged_and_kernel(scene, W, H, max_depth, ortho)
    assert np.isfinite(got).all()
    # same uniforms, same formulas: only float summation order differs
    np.testing.assert_allclose(got, ref, atol=2e-5)
    if scene == "empty":  # pure sky gradient, every pixel lit
        assert got.min() > 0.4


def test_kernel_accumulates_in_place():
    """Running average from a nonzero history (frame 3, two samples): the
    aliased update must equal the staged route's lin = c/n + lin*(n-1)/n."""
    got, ref = _staged_and_kernel("demo", 16, 8, 5, False, spp=2, frame=3,
                                  init=0.3)
    np.testing.assert_allclose(got, ref, atol=2e-5)
    # the history carries weight 3/5 after two more samples
    assert abs(float(got.mean()) - 0.3) < 0.5


def test_sample_uniforms_are_the_staged_draws():
    """Row 2b/2b+1 are exactly `materials.scatter`'s cosine-sample draws."""
    key = rng.key_for(5)
    jitter, urand = path_kernel.sample_uniforms(key, 64, 3)
    np.testing.assert_array_equal(
        jitter, rng.pixel_jitter(rng.fold(key, 0x9E37), (64,)))
    for b in range(3):
        local = rng.cosine_weighted(rng.fold(key, b), (64,))
        u1, u2 = urand[2 * b], urand[2 * b + 1]
        np.testing.assert_allclose(
            local[:, 0], jnp.cos(2.0 * math.pi * u1) * jnp.sqrt(u2), atol=1e-6)
        np.testing.assert_allclose(local[:, 2], jnp.sqrt(1.0 - u2), atol=1e-6)


# ---------------------------------------------------------------- route


def test_route_is_staged_off_gpu(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("path kernel used off the GPU")

    monkeypatch.setattr(path_kernel, "accumulate", boom)
    assert not pt.uses_path_kernel()
    pkt = demo.reference_demo_scene(8, 4).build_packet()
    cam = cam_ops.Camera.create(width=8, height=4)
    out = pt.render_step(pkt, cam, pt.AccumState.create(4, 8),
                         rng.key_for(0), RenderConfig(width=8, height=4))
    assert int(out.frame) == 1


def test_route_takes_kernel_on_gpu_never_interpreted(monkeypatch):
    calls = []

    def fake(key, packet, cam, linear, frame, config, spp=1,
             interpret=False):
        calls.append(interpret)
        return linear + 1.0

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(path_kernel, "accumulate", fake)
    assert pt.uses_path_kernel()
    pkt = demo.reference_demo_scene(8, 4).build_packet()
    cam = cam_ops.Camera.create(width=8, height=4)
    out = pt.render_step(pkt, cam, pt.AccumState.create(4, 8),
                         rng.key_for(0), RenderConfig(width=8, height=4),
                         spp=3)
    assert calls == [False]  # one kernel loop, compiled (not interpreted)
    assert int(out.frame) == 3 and float(out.linear.min()) == 1.0


def test_route_follows_default_device(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with jax.default_device(jax.devices("cpu")[0]):
        assert not pt.uses_path_kernel()


# ---------------------------------------------------------------- precision


def _dot_precisions(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn.params["precision"]
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (tuple, list)) else (v,)):
                if isinstance(sub, jax.extend.core.ClosedJaxpr):
                    yield from _dot_precisions(sub.jaxpr)
                elif isinstance(sub, jax.extend.core.Jaxpr):
                    yield from _dot_precisions(sub)


def _assert_highest(jaxpr):
    precs = list(_dot_precisions(jaxpr.jaxpr))
    assert precs, "no contraction found"
    hi = jax.lax.Precision.HIGHEST
    for p in precs:
        assert p is not None, "dot_general at default precision"
        ps = p if isinstance(p, tuple) else (p, p)
        assert all(q == hi for q in ps), p


def test_render_step_contractions_are_highest_precision():
    pkt = demo.config3_scene(segments=8, rings=4).build_packet()
    cam = cam_ops.Camera.create(width=8, height=4)
    cfg = RenderConfig(width=8, height=4)
    _assert_highest(jax.make_jaxpr(
        lambda p, c, a, k: pt.render_step(p, c, a, k, cfg))(
            pkt, cam, pt.AccumState.create(4, 8), rng.key_for(0)))


def test_mse_step_contractions_are_highest_precision():
    pkt = demo.config3_scene(segments=8, rings=4).build_packet()
    cam = cam_ops.Camera.create(width=8, height=4)
    cfg = RenderConfig(width=8, height=4)
    params = sh.differentiable_params(pkt, cam)
    target = jnp.zeros((32, 3), jnp.float32)
    _assert_highest(jax.make_jaxpr(
        lambda p, k: train.mse_step(p, pkt, cam, target, k, cfg, spp=2))(
            params, rng.key_for(0)))


# ---------------------------------------------------------------- pytrees


def _pytrees():
    pkt = demo.reference_demo_scene(8, 4).build_packet()
    r = jnp.ones((4,), jnp.float32)
    v = jnp.ones((4, 3), jnp.float32)
    return {
        "ScenePacket": pkt,
        "Camera": cam_ops.Camera.create(width=32, height=16),
        "AccumState": pt.AccumState.create(4, 8),
        "HitRecord": intersect.HitRecord(
            t=r, position=v, normal=v, front_face=r > 0,
            mat_id=r.astype(jnp.int32), hit=r > 0),
        "ScatterRecord": materials.ScatterRecord(
            attenuation=v, pdf=r, cos_weight=r, next_origin=v, next_dir=v,
            terminated=r > 0),
    }


@pytest.mark.parametrize("name", sorted(_pytrees()))
def test_dataclass_pytree_round_trip(name):
    obj = _pytrees()[name]
    leaves, tree = jax.tree.flatten(obj)
    back = jax.tree.unflatten(tree, leaves)
    assert type(back) is type(obj)
    for a, b in zip(jax.tree.leaves(obj), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    # static fields live in the treedef, not among the leaves
    if name == "Camera":
        assert all(not isinstance(x, int) for x in leaves)
        assert back.width == 32 and back.height == 16
    if name == "ScenePacket":
        assert back.num_triangles == obj.num_triangles > 0
    # jit round trip and functional replace
    out = jax.jit(lambda o: jax.tree.map(lambda x: x, o))(obj)
    assert jax.tree.structure(out) == tree
    first = jax.tree.leaves(obj)[0]
    field = next(f for f in type(obj).__dataclass_fields__
                 if getattr(obj, f) is first)
    assert getattr(obj.replace(**{field: first}), field) is first


# ---------------------------------------------------------------- on the card


@pytest.mark.gpu
@pytest.mark.parametrize("scene", ["demo", "config3"])
def test_compiled_kernel_matches_staged_on_gpu(scene):
    W, H = 96, 64
    pkt = SCENES[scene]().build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    key = rng.key_for(2)
    accum = pt.AccumState.create(H, W)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda: pt.staged_render_step(pkt, cam, accum, key,
                                                    cfg).linear)()
        got = pt.render_step_jit(pkt, cam, pt.AccumState.create(H, W), key,
                                 cfg).linear
    d = np.abs(np.asarray(got) - np.asarray(ref)).max(axis=-1)
    assert np.mean(d > 1e-3) <= 1e-3
    assert float(np.mean(d)) <= 1e-5


@pytest.mark.gpu
def test_gpu_route_uses_kernel():
    assert pt.uses_path_kernel()
