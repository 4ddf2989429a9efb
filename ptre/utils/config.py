"""Runtime configuration.

The reference has no config system — every knob is a compile-time constant
(window 1280x720 `window.h:40-41`, RNG seed 1984 `path_tracer.cu:45`,
max_depth 5 and t-range `path_tracer.cu:240-241`, kernel cadence 0.1 s
`path_tracer.cu:378`, MSAA 4x `rasterizer.cu:31`, camera pose/fov
`camera.h:11,26-27`, materials `path_tracer.cu:248-249`). Here they are all
runtime parameters; defaults reproduce the reference exactly.
"""

from __future__ import annotations

import dataclasses

from ptre.utils.errors import ConfigError


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Path-tracer + framebuffer configuration (static: changes recompile)."""

    width: int = 1280  # `window.h:40`
    height: int = 720  # `window.h:41`
    samples_per_launch: int = 1  # 1 spp per kernel launch (`path_tracer.cu:402`)
    max_depth: int = 5  # `path_tracer.cu:240`
    t_min: float = 1e-6  # `path_tracer.cu:241`
    t_max: float = 999.99  # `path_tracer.cu:241`
    seed: int = 1984  # `path_tracer.cu:45`
    #: per-sample clamp to [0,1] before accumulation (`path_tracer.cu:345-348`)
    clamp_samples: bool = True
    #: sqrt display gamma (`path_tracer.cu:360-363`); False = linear output
    sqrt_gamma: bool = True
    #: sky gradient endpoints (`path_tracer.cu:307-316`)
    sky_bottom: tuple = (1.0, 1.0, 1.0)
    sky_top: tuple = (0.5, 0.7, 1.0)
    #: scattered-ray origin offset along the normal (`material.cu:11,16`)
    shadow_eps: float = 1e-4
    #: degenerate-pdf threshold (`material.cu:15`)
    pdf_eps: float = 1e-5
    #: Möller–Trumbore determinant epsilon (`shape.cu:72` via `iqmath.h:29`)
    det_eps: float = 1e-6
    #: auto-reset accumulation on scene edits. The reference does NOT reset
    #: (ghosting; manual right-click reset — `application.cu:87-89`), so the
    #: flag-compatible default is False.
    reset_on_edit: bool = False
    #: rematerialize the bounce body in the backward pass (`jax.checkpoint`).
    #: Without it, autodiff of the bounce scan stores every per-bounce
    #: intermediate — about 20 (R, 3) float32 arrays per bounce, 0.5 GB per
    #: bounce at 1080p; with it, only the small scan carry and the pinned
    #: O(R) residuals are saved and the bounce recomputes on the way back
    #: (the SURVEY §7 "re-intersect instead of storing hits" design).
    #: Identical values either way.
    remat_bounces: bool = True

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ConfigError(f"invalid resolution {self.width}x{self.height}")
        if self.max_depth < 1:
            raise ConfigError("max_depth must be >= 1")
        if self.samples_per_launch < 1:
            raise ConfigError("samples_per_launch must be >= 1")


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    """Rasterizer configuration (reference `rasterizer.cu`)."""

    width: int = 1280
    height: int = 720
    #: supersampling factor per axis; 2 → 4 samples/pixel, the MSAA 4x
    #: analogue (`rasterizer.cu:31,36-37`; resolved by box filter like
    #: ResolveSubresource)
    supersample: int = 2
    #: clear color = sky blue (`renderer_base.cu:30`)
    clear_color: tuple = (0.62, 0.84, 1.0)
    #: back-face culling of clockwise-front primitives (`rasterizer.cu:117-124`)
    cull_backfaces: bool = True
    #: ambient term strength (pixel_shader.hlsl)
    ambient_strength: float = 0.2
    #: directional light dir, normalized at use (pixel_shader.hlsl)
    light_dir: tuple = (0.0, -1.0, 0.0)
    #: hard-coded red albedo (pixel_shader.hlsl)
    albedo: tuple = (1.0, 0.0, 0.0)

    def __post_init__(self):
        if self.supersample < 1:
            raise ConfigError("supersample must be >= 1")
