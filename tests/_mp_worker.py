"""Multi-process worker: one host of a simulated multi-host render/train job.

Launched by tests/test_multihost.py as
``python tests/_mp_worker.py <pid> <nproc> <port> <expected.npz>``.

Each process gets 4 virtual CPU devices; `jax.distributed.initialize` joins
them into one 4*nproc-device job (the SURVEY §4 multi-host-on-CPU
prescription). The worker runs the sharded render + train steps over the
GLOBAL mesh and asserts its addressable shards match the single-process
expectation computed by the parent — proving the bootstrap, the global-array
plumbing and the cross-process psums end-to-end.
"""

import os
import sys

pid, nproc, port, expected_path = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
)

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ptre.models import demo  # noqa: E402
from ptre.ops import camera as cam_ops, rng  # noqa: E402
from ptre.parallel import distributed as dist  # noqa: E402
from ptre.parallel import sharding as sh  # noqa: E402
from ptre.render import pathtracer as pt  # noqa: E402
from ptre.utils.config import RenderConfig  # noqa: E402

H = W = 16


def main():
    dist.initialize(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.local_device_count() == 4
    assert jax.device_count() == 4 * nproc
    assert dist.is_multihost()

    exp = np.load(expected_path)
    mesh = dist.global_mesh((int(exp["dp"]), int(exp["sp"])))

    scn = demo.reference_demo_scene(8, 4)
    pkt = scn.build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    key = rng.key_for(7)

    pkt_g = dist.replicate_global(mesh, pkt)
    key_g = dist.replicate_global(mesh, key)

    # ---- sharded progressive render over the global mesh ------------------
    accum = pt.AccumState(
        linear=dist.shard_rows_global(mesh, np.zeros((H, W, 3), np.float32)),
        frame=dist.replicate_global(mesh, np.zeros((), np.int32)),
    )
    step = sh.make_render_step(mesh, cam, cfg, spp=2)
    out = step(pkt_g, accum, key_g)
    assert int(np.asarray(out.frame.addressable_shards[0].data)) == 2
    expected_linear = exp["linear"]
    for shard in out.linear.addressable_shards:
        np.testing.assert_allclose(
            np.asarray(shard.data), expected_linear[shard.index],
            atol=1e-6, rtol=1e-6,
        )

    # ---- sharded train step: loss + psum'd grads across processes ---------
    params = sh.differentiable_params(pkt, cam)
    params_g = dist.replicate_global(mesh, params)
    target_g = dist.shard_rows_global(
        mesh, np.zeros((H, W, 3), np.float32)
    )
    tstep = sh.make_train_step(mesh, cam, cfg, spp=2)
    loss, grads, _ = tstep(params_g, pkt_g, target_g, key_g)
    np.testing.assert_allclose(
        float(np.asarray(loss.addressable_shards[0].data)),
        float(exp["loss"]), atol=1e-6, rtol=1e-6,
    )
    for name in ("sph_radius", "mat_albedo", "cam_fov"):
        got = np.asarray(grads[name].addressable_shards[0].data)
        np.testing.assert_allclose(
            got, exp[f"grad_{name}"], atol=1e-6, rtol=1e-5
        )

    print(f"WORKER_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
