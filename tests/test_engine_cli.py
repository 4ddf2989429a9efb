"""Engine facade, checkpoint/resume, CLI, metrics tests."""

import os

import numpy as np
import pytest

from ptre.models import demo
from ptre.ops import camera as cam_ops
from ptre.render import pathtracer as pt
from ptre.render.engine import EngineKind, Renderer
from ptre.utils import checkpoint as ckpt
from ptre.utils.config import RasterConfig, RenderConfig
from ptre.utils.errors import CheckpointError
from ptre.utils.image import read_ppm, write_ppm


def _renderer(w=24, h=16, **kw):
    scn = demo.reference_demo_scene(8, 4)
    cam = cam_ops.Camera.create(width=w, height=h)
    return Renderer(
        scn, cam, RenderConfig(width=w, height=h),
        RasterConfig(width=w, height=h, supersample=1), **kw,
    )


def test_default_engine_is_pathtracer():
    r = _renderer()
    assert r.engine == EngineKind.PATHTRACER  # `renderer.cu:70-78`


def test_engine_toggle_deferred_to_frame_boundary():
    r = _renderer()
    r.toggle_engine()
    assert r.engine == EngineKind.PATHTRACER  # not yet (`renderer.cu:45-53`)
    r.draw_frame()
    assert r.engine == EngineKind.RASTERIZER
    r.toggle_engine()
    r.draw_frame()
    assert r.engine == EngineKind.PATHTRACER


def test_progressive_accumulation_across_frames():
    r = _renderer()
    r.draw_frame()
    assert int(r.accum.frame) == 1
    r.draw_frame()
    assert int(r.accum.frame) == 2
    r.reset()
    r.draw_frame()
    assert int(r.accum.frame) == 1  # pending reset applied at frame start


def test_scene_edit_rebuilds_packet_without_reset():
    # reference quirk: edits do NOT reset accumulation (`application.cu:87-89`)
    r = _renderer()
    img1 = r.draw_frame()
    r.scene.get_model("wall").set_transforms(1.0, 0.0, (0.5, 0.5, 0.0))
    assert r.scene.modified()
    r.draw_frame()
    assert int(r.accum.frame) == 2  # accumulated through the edit (ghosting)


def test_reset_on_edit_config():
    scn = demo.reference_demo_scene(8, 4)
    cam = cam_ops.Camera.create(width=24, height=16)
    r = Renderer(
        scn, cam, RenderConfig(width=24, height=16, reset_on_edit=True),
        RasterConfig(width=24, height=16, supersample=1),
    )
    r.draw_frame()
    r.scene.get_model("wall").set_transforms(1.0, 0.0, (0.5, 0.5, 0.0))
    r.draw_frame()
    assert int(r.accum.frame) == 1  # auto-reset applied


def test_run_sequence_and_metrics(tmp_path):
    r = _renderer()
    last = r.run(3, out_dir=str(tmp_path), file_pattern="f_{:03d}.ppm")
    assert last.shape == (16, 24, 3) and last.dtype == np.uint8
    assert sorted(os.listdir(tmp_path)) == ["f_000.ppm", "f_001.ppm", "f_002.ppm"]
    assert r.metrics.fps > 0 and r.metrics.mrays_per_s > 0
    assert "fps:" in r.metrics.summary()


def test_toggle_every_in_run(tmp_path):
    r = _renderer()
    r.run(4, out_dir=str(tmp_path), toggle_every=2)
    # toggle queued at i=2 → frames 0-1 path-traced, 2-3 rasterized
    assert r.engine == EngineKind.RASTERIZER
    assert int(r.accum.frame) == 2  # only the PT frames accumulated
    assert len(r.metrics.frames) == 4


def test_checkpoint_roundtrip(tmp_path):
    r = _renderer()
    r.draw_frame()
    r.draw_frame()
    path = str(tmp_path / "state.npz")
    ckpt.save_render_state(path, r.accum, 1984, 2, extra={"note": np.arange(3)})
    accum, seed, fi, extra = ckpt.load_render_state(path)
    assert seed == 1984 and fi == 2
    np.testing.assert_array_equal(np.asarray(accum.linear), np.asarray(r.accum.linear))
    assert int(accum.frame) == 2
    np.testing.assert_array_equal(np.asarray(extra["note"]), [0, 1, 2])

    # resume continues the running average exactly
    r2 = _renderer()
    r2.accum = accum
    r2._frame_index = fi
    r2.draw_frame()
    assert int(r2.accum.frame) == 3


def test_checkpoint_missing_raises(tmp_path):
    with pytest.raises(CheckpointError):
        ckpt.load_render_state(str(tmp_path / "nope.npz"))


def test_ppm_roundtrip(tmp_path):
    img = (np.arange(2 * 3 * 3) % 256).astype(np.uint8).reshape(2, 3, 3)
    p = str(tmp_path / "x.ppm")
    write_ppm(p, img)
    back = read_ppm(p)
    np.testing.assert_array_equal(back, img)


def test_cli_render_and_info(tmp_path, capsys):
    from ptre import cli

    rc = cli.main([
        "render", "--scene", "demo", "--width", "24", "--height", "16",
        "--frames", "2", "--spp", "1", "--out", str(tmp_path / "f"),
        "--format", "ppm",
        "--checkpoint", str(tmp_path / "ck.npz"),
    ])
    assert rc == 0
    assert sorted(os.listdir(tmp_path / "f")) == ["frame_00000.ppm", "frame_00001.ppm"]
    assert os.path.exists(tmp_path / "ck.npz")

    # resume from the checkpoint
    rc = cli.main([
        "render", "--scene", "demo", "--width", "24", "--height", "16",
        "--frames", "1", "--out", str(tmp_path / "g"), "--format", "ppm",
        "--resume", str(tmp_path / "ck.npz"),
    ])
    assert rc == 0

    rc = cli.main(["info"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "devices" in out


def test_cli_raster_engine(tmp_path):
    from ptre import cli

    rc = cli.main([
        "render", "--engine", "raster", "--width", "24", "--height", "16",
        "--frames", "1", "--out", str(tmp_path / "r"), "--format", "ppm",
    ])
    assert rc == 0
    img = read_ppm(str(tmp_path / "r" / "frame_00000.ppm"))
    assert img.shape == (16, 24, 3)


def test_present_lags_by_one_frame():
    """Async dispatch-ahead contract (`path_tracer.cu:368-404`): draw_frame
    presents the PREVIOUS frame's display image; the first frame presents
    the cleared framebuffer. flush() materializes the in-flight frame."""
    r = _renderer()
    r_sync = _renderer(present_async=False)

    f0 = r.draw_frame()
    assert (f0 == 0).all()  # cleared framebuffer (memset 0)
    s0 = r_sync.draw_frame()
    f1 = r.draw_frame()
    np.testing.assert_array_equal(f1, s0)  # lag-by-one vs sync
    s1 = r_sync.draw_frame()
    f2 = r.draw_frame()
    np.testing.assert_array_equal(f2, s1)
    # flush materializes the in-flight frame 2
    s2 = r_sync.draw_frame()
    np.testing.assert_array_equal(r.flush(), s2)
    assert r.flush() is None


def test_engine_switch_drops_inflight_frame():
    r = _renderer()
    r.draw_frame()
    r.toggle_engine()
    img = r.draw_frame()  # raster presents synchronously
    assert img.shape == (16, 24, 3)
    assert r._pending_disp is None
