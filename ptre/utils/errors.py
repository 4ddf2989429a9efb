"""Typed error hierarchy.

JAX equivalent of the reference's exception stack
(`IoniqRE/ioniq_exception.{h,cu}`, `renderer_base.h:11-51`,
`window.cu:203-233`): every failure is a typed exception carrying enough
context to diagnose without a debugger. JAX's functional model removes the
HRESULT/cudaError plumbing; what remains is scene/config/runtime validation.
"""

from __future__ import annotations


class IoniqError(Exception):
    """Base framework error (reference `ioniq_exception.h:6-22`)."""


class SceneError(IoniqError):
    """Invalid scene-graph operation (reference logs-as-comments, `scene.cu:19,52`)."""


class ConfigError(IoniqError):
    """Invalid render/engine configuration."""


class RendererError(IoniqError):
    """Render-path failure (reference `hr_exception`/`cuda_exception` analogue)."""


class CheckpointError(IoniqError):
    """Checkpoint save/load failure."""
