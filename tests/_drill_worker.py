"""Fault-drill worker: one host of a multi-process progressive render job
that checkpoints its accumulation shards every step and can be scripted to
die mid-job.

Launched by tests/test_multihost.py::test_fault_drill_resume_matches as
``python tests/_drill_worker.py <pid> <nproc> <port> <ckpt_dir> <steps>
  <die_pid> <die_after> <resume> <out.npz>``

Implements SURVEY §5's recovery contract: multi-host render jobs tolerate
restart by recomputing from the last accumulation snapshot. Each process
persists ITS addressable shards (atomic tmp+rename npz) after every
progressive step; on ``resume=1`` it rebuilds the global sharded
accumulator from the snapshots and continues at the recorded step cursor.
A scripted worker death (``die_pid``/``die_after``) exits hard with
os._exit mid-job, leaving the surviving peer blocked in the next
collective — the supervisor (the test) detects the abnormal exit, reaps
the hung peer, and relaunches with resume.
"""

import os
import sys

(pid, nproc, port, ckpt_dir, steps, die_pid, die_after, resume, out_path) = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    int(sys.argv[5]), int(sys.argv[6]), int(sys.argv[7]), int(sys.argv[8]),
    sys.argv[9],
)

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ptre.models import demo  # noqa: E402
from ptre.ops import camera as cam_ops, rng  # noqa: E402
from ptre.parallel import distributed as dist  # noqa: E402
from ptre.parallel import sharding as sh  # noqa: E402
from ptre.render import pathtracer as pt  # noqa: E402
from ptre.utils.config import RenderConfig  # noqa: E402

H = W = 16
DP = 8


def _ckpt_path(step):
    return os.path.join(ckpt_dir, f"shard{pid}_step{step}.npz")


def _save_shards(accum, step):
    payload = {"frame": np.asarray(accum.frame), "step": np.int64(step)}
    for n, shard in enumerate(accum.linear.addressable_shards):
        payload[f"row{n}"] = np.int64(shard.index[0].start or 0)
        payload[f"data{n}"] = np.asarray(shard.data)
    tmp = _ckpt_path(step) + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, _ckpt_path(step))  # atomic: readers never see partials
    # cursor file points at the last COMPLETE step
    cur = os.path.join(ckpt_dir, f"cursor{pid}.tmp")
    with open(cur, "w") as f:
        f.write(str(step))
    os.replace(cur, os.path.join(ckpt_dir, f"cursor{pid}"))


def _load_shards(mesh):
    with open(os.path.join(ckpt_dir, f"cursor{pid}")) as f:
        step = int(f.read())
    z = np.load(_ckpt_path(step))
    by_row = {}
    n = 0
    while f"row{n}" in z.files:
        by_row[int(z[f"row{n}"])] = z[f"data{n}"]
        n += 1

    def lookup(idx):
        return by_row[idx[0].start or 0]

    linear = dist.make_global_array(mesh, P("dp"), (H, W, 3), lookup)
    frame = dist.replicate_global(mesh, np.asarray(z["frame"]))
    return pt.AccumState(linear=linear, frame=frame), step


def main():
    dist.initialize(f"localhost:{port}", nproc, pid)
    mesh = dist.global_mesh((DP, 1))

    scn = demo.reference_demo_scene(8, 4)
    pkt = scn.build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    key = rng.key_for(7)
    pkt_g = dist.replicate_global(mesh, pkt)
    step_fn = sh.make_render_step(mesh, cam, cfg, spp=2)

    if resume:
        accum, done = _load_shards(mesh)
        start = done + 1
    else:
        accum = pt.AccumState(
            linear=dist.shard_rows_global(
                mesh, np.zeros((H, W, 3), np.float32)),
            frame=dist.replicate_global(mesh, np.zeros((), np.int32)),
        )
        start = 0

    for s in range(start, steps):
        accum = step_fn(pkt_g, accum, dist.replicate_global(
            mesh, rng.fold(key, s)))
        accum.linear.block_until_ready()
        _save_shards(accum, s)
        if pid == die_pid and s == die_after:
            # scripted mid-job death: hard exit AFTER the step-s checkpoint;
            # the peer blocks in step s+1's collective until the supervisor
            # reaps it
            os._exit(17)

    payload = {"frame": np.asarray(accum.frame)}
    for n, shard in enumerate(accum.linear.addressable_shards):
        payload[f"row{n}"] = np.int64(shard.index[0].start or 0)
        payload[f"data{n}"] = np.asarray(shard.data)
    with open(out_path, "wb") as f:
        np.savez(f, **payload)
    print(f"DRILL_OK {pid}", flush=True)


if __name__ == "__main__":
    main()
