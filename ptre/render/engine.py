"""Engine facade: two swappable engines over one scene, frame loop.

JAX equivalent of the dispatch layer (`IoniqRE/renderer.{h,cu}`,
`renderer_template.h`, `application.cu`):

  * two engines (PATHTRACER default — `renderer.cu:70-78`) behind one
    facade, toggled live; the switch is DEFERRED to the next frame boundary
    exactly like `renderer.cu:45-53` ("make sure the engine is not changing
    mid-frame");
  * `reset()` forwards to the path tracer's accumulation restart
    (`renderer.cu:65-68`, `path_tracer.h:35`), applied between launches via a
    pending flag (`path_tracer.h:65`);
  * scene edits mark the scene modified; the packet is rebuilt lazily at the
    next path-traced frame (`path_tracer.cu:389-392`) — and, per the
    reference's quirk contract, accumulation is NOT auto-reset on edits
    (ghosting; `application.cu:87-89`) unless config.reset_on_edit is set;
  * the Win32 message pump / swap chain is replaced by a frame-sequence API
    (`run()` renders N frames to files), fulfilling the reference README's
    planned "means to render sequences of frames".
"""

from __future__ import annotations

import enum
import os
import time
from typing import Optional

import numpy as np

from ptre.models.scene import Scene
from ptre.ops import camera as cam_ops
from ptre.ops import rng
from ptre.render import pathtracer as pt
from ptre.render import rasterizer as ras
from ptre.utils.config import RasterConfig, RenderConfig
from ptre.utils.image import write_image
from ptre.utils.metrics import Metrics


class EngineKind(enum.IntEnum):
    RASTERIZER = 0
    PATHTRACER = 1  # default engine (`renderer.cu:70-78`)


class Renderer:
    """Host-side frame-loop driver over the jitted engines."""

    def __init__(
        self,
        scene: Scene,
        camera: cam_ops.Camera,
        config: Optional[RenderConfig] = None,
        raster_config: Optional[RasterConfig] = None,
        engine: EngineKind = EngineKind.PATHTRACER,
        spp_per_frame: int = 1,
        ray_chunk: int = 0,
        row_chunk: int = 0,
        present_async: bool = True,
    ):
        self.scene = scene
        self.camera = camera
        self.config = config or RenderConfig(width=camera.width, height=camera.height)
        self.raster_config = raster_config or RasterConfig(
            width=camera.width, height=camera.height
        )
        self._engine = engine
        self._pending_engine: Optional[EngineKind] = None
        self._pending_reset = False
        self.spp_per_frame = spp_per_frame
        self.ray_chunk = ray_chunk
        self.row_chunk = row_chunk

        self._pt_packet = None
        self._raster_packet = None
        self.accum = pt.AccumState.create(camera.height, camera.width)
        self._key = rng.key_for(self.config.seed)
        self._frame_index = 0
        self.metrics = Metrics()
        #: display-last-frame async overlap (`path_tracer.cu:368-404`): the
        #: render step for frame N is dispatched and left running while the
        #: PREVIOUS frame's (device-resident) display image is materialized
        #: and presented — the host never hard-syncs on the frame it just
        #: launched. present_async=False restores synchronous presentation.
        self.present_async = present_async
        self._pending_disp = None

    # -- facade surface (`renderer.h:26-36`) --------------------------------
    @property
    def engine(self) -> EngineKind:
        return self._engine

    def toggle_engine(self):
        """Queue an engine switch for the next frame boundary (`renderer.cu:45-53`)."""
        target = (
            EngineKind.RASTERIZER
            if self._engine == EngineKind.PATHTRACER
            else EngineKind.PATHTRACER
        )
        self._pending_engine = target

    def set_engine(self, kind: EngineKind):
        self._pending_engine = kind

    def reset(self):
        """Queue an accumulation restart (`path_tracer.h:65` pending flag)."""
        self._pending_reset = True

    # -- frame loop ----------------------------------------------------------
    def begin_frame(self):
        if self._pending_engine is not None:
            if self._pending_engine != self._engine:
                self._pending_disp = None  # drop in-flight frame on switch
            self._engine = self._pending_engine
            self._pending_engine = None

    def _ensure_packets(self):
        if self.scene.modified() or self._pt_packet is None:
            self._pt_packet = self.scene.build_packet()
            self._raster_packet = self.scene.build_packet(spheres_as_triangles=True)
            if self.config.reset_on_edit:
                self._pending_reset = True

    def draw_frame(self) -> np.ndarray:
        """Render one frame with the active engine → uint8 RGB (H, W, 3)."""
        self.begin_frame()
        self._ensure_packets()
        t0 = time.perf_counter()
        if self._engine == EngineKind.PATHTRACER:
            if self._pending_reset:
                self.accum = self.accum.reset()
                self._pending_reset = False
            self.accum = pt.render_step_jit(
                self._pt_packet,
                self.camera,
                self.accum,
                rng.fold(self._key, self._frame_index),
                self.config,
                spp=self.spp_per_frame,
                ray_chunk=self.ray_chunk,
            )
            # async dispatch-ahead: convert to display ON DEVICE, then
            # present the previous frame's image (materializing it is the
            # only host sync — by now it has had a full frame to finish);
            # mirrors the reference's display-last-completed-frame contract
            # (`path_tracer.cu:375-385`)
            disp = pt.to_display(self.accum.linear, self.config.sqrt_gamma)
            if self.present_async:
                prev, self._pending_disp = self._pending_disp, disp
                if prev is None:
                    # first frame: the cleared framebuffer (memset 0 —
                    # `path_tracer.cu:394-400`)
                    img = np.zeros(
                        (self.camera.height, self.camera.width, 3), np.uint8
                    )
                else:
                    img = np.asarray(prev)
            else:
                img = np.asarray(disp)
            rays = (
                self.camera.width * self.camera.height
                * self.spp_per_frame * self.config.max_depth
            )
        else:
            out = ras.rasterize_jit(
                self._raster_packet, self.camera, self.raster_config,
                row_chunk=self.row_chunk,
            )
            img = np.asarray((np.clip(np.asarray(out), 0.0, 1.0) * 255).astype(np.uint8))
            rays = self.camera.width * self.camera.height
        self.metrics.frame(time.perf_counter() - t0, rays, int(self.accum.frame))
        self._frame_index += 1
        return img

    def flush(self) -> Optional[np.ndarray]:
        """Materialize and return the in-flight frame (None if none pending).
        The async analogue of the reference's final cudaDeviceSynchronize."""
        if self._pending_disp is None:
            return None
        img = np.asarray(self._pending_disp)
        self._pending_disp = None
        return img

    def run(
        self,
        frames: int,
        out_dir: Optional[str] = None,
        file_pattern: str = "frame_{:05d}.png",
        toggle_every: int = 0,
    ):
        """Render a frame sequence; optionally toggle engines periodically
        (the CLI stand-in for the reference's live `P` key)."""
        last = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
        for i in range(frames):
            if toggle_every and i and i % toggle_every == 0:
                self.toggle_engine()
            last = self.draw_frame()
            if out_dir:
                write_image(os.path.join(out_dir, file_pattern.format(i)), last)
        return last
