"""Multi-host (multi-process) tests: real `jax.distributed` jobs on localhost.

The parent (this pytest process, 8 virtual single-process devices) computes
the expected sharded render/train results; then N processes with 4 virtual
devices each are spawned, joined via `jax.distributed.initialize`, and must
reproduce them shard-for-shard — the SURVEY §4 "multi-host tests driven on
CPU via jax.distributed" prescription backing the ≥85% multi-host north star.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from ptre.models import demo
from ptre.ops import camera as cam_ops, rng
from ptre.parallel import sharding as sh
from ptre.render import pathtracer as pt
from ptre.utils.config import RenderConfig

# slow tier: real 2-process jax.distributed runs (~minutes on a shared host)
pytestmark = pytest.mark.slow

H = W = 16
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _expected(dp: int, sp: int, path: str):
    """Single-process expectation for mesh (dp, sp) — the shard math depends
    only on mesh coordinates, so it matches the multi-process run exactly."""
    scn = demo.reference_demo_scene(8, 4)
    pkt = scn.build_packet()
    cam = cam_ops.Camera.create(width=W, height=H)
    cfg = RenderConfig(width=W, height=H)
    key = rng.key_for(7)
    mesh = sh.make_mesh((dp, sp))

    accum = pt.AccumState.create(H, W)
    out = sh.shard_render_step(mesh, pkt, cam, accum, key, cfg, spp=2)

    params = sh.differentiable_params(pkt, cam)
    target = np.zeros((H, W, 3), np.float32)
    loss, grads, _ = sh.shard_train_step(
        mesh, params, pkt, cam, target, key, cfg, spp=2
    )
    np.savez(
        path, dp=dp, sp=sp, linear=np.asarray(out.linear),
        loss=np.asarray(loss),
        grad_sph_radius=np.asarray(grads["sph_radius"]),
        grad_mat_albedo=np.asarray(grads["mat_albedo"]),
        grad_cam_fov=np.asarray(grads["cam_fov"]),
    )


@pytest.mark.parametrize("dp,sp", [(8, 1), (4, 2)])
def test_multiprocess_matches_single_process(tmp_path, dp, sp):
    expected = str(tmp_path / "expected.npz")
    _expected(dp, sp, expected)

    nproc = 2
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.join(_ROOT, "tests", "_mp_worker.py"),
             str(pid), str(nproc), str(port), expected],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=_ROOT,
        )
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"WORKER_OK {pid}" in out


def _launch_drill(tmp_path, tag, port, die_pid=-1, die_after=-1, resume=0,
                  steps=4):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs, outs = [], []
    for pid in range(2):
        out_npz = str(tmp_path / f"{tag}_final{pid}.npz")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(_ROOT, "tests", "_drill_worker.py"),
             str(pid), "2", str(port), str(tmp_path), str(steps),
             str(die_pid), str(die_after), str(resume), out_npz],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=_ROOT))
    return procs


def test_fault_drill_resume_matches(tmp_path):
    """SURVEY §5 failure recovery, end to end: kill one worker of a
    2-process `jax.distributed` progressive render MID-JOB (after its
    step-1 checkpoint), detect the abnormal exit, reap the hung survivor,
    relaunch the job resuming from the last accumulation snapshot — and
    the final image must EQUAL an uninterrupted run's, shard for shard."""
    # --- reference: uninterrupted 4-step job -------------------------------
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    procs = _launch_drill(ref_dir, "ref", _free_port())
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0 and f"DRILL_OK {pid}" in out, out

    # --- phase 1: worker 1 dies after completing step 1 --------------------
    drill_dir = tmp_path / "drill"
    drill_dir.mkdir()
    procs = _launch_drill(drill_dir, "p1", _free_port(), die_pid=1,
                          die_after=1)
    out1, _ = procs[1].communicate(timeout=600)
    assert procs[1].returncode == 17, (procs[1].returncode, out1)  # detected
    # the survivor is blocked in step 2's collective: reap it by exact PID
    try:
        procs[0].communicate(timeout=10)
        # (it may have failed fast on the dead peer instead — also fine)
    except subprocess.TimeoutExpired:
        procs[0].kill()
        procs[0].communicate()

    # both workers checkpointed step 1 before the death
    for pid in range(2):
        with open(drill_dir / f"cursor{pid}") as f:
            assert int(f.read()) >= 1

    # --- phase 2: relaunch resuming from the snapshots ---------------------
    procs = _launch_drill(drill_dir, "p2", _free_port(), resume=1)
    for pid, p in enumerate(procs):
        out, _ = p.communicate(timeout=600)
        assert p.returncode == 0 and f"DRILL_OK {pid}" in out, out

    # --- resumed == uninterrupted, shard for shard -------------------------
    for pid in range(2):
        ref = np.load(tmp_path / "ref" / f"ref_final{pid}.npz")
        got = np.load(drill_dir / f"p2_final{pid}.npz")
        assert int(ref["frame"]) == int(got["frame"]) == 8  # 4 steps x spp 2
        n = 0
        while f"row{n}" in ref.files:
            assert int(ref[f"row{n}"]) == int(got[f"row{n}"])
            np.testing.assert_array_equal(ref[f"data{n}"], got[f"data{n}"])
            n += 1
        assert n > 0
