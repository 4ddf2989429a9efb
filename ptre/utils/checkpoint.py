"""Checkpoint / resume of progressive renders and optimization loops.

The reference has NO persistence: its only durable state is the on-device
accumulation buffer + frame counter (`path_tracer.h:61-62`), lost on exit
(`image.ppm` stayed 0 bytes). Here: save/load of (accumulation buffer, sample
count, RNG seed + frame cursor, differentiable scene/camera parameters) so
long progressive renders and optimization runs survive restarts — the
multi-host fault-tolerance story is "recompute from the last accumulation
snapshot" (SURVEY §5 failure detection).

Format: a single .npz (portable, dependency-free). Orbax is available in the
image for users who want async checkpointing of bigger states; this module
keeps the dependency optional.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import jax.numpy as jnp
import numpy as np

from ptre.render.pathtracer import AccumState
from ptre.utils.errors import CheckpointError

_FORMAT_VERSION = 1


def save_render_state(
    path: str,
    accum: AccumState,
    seed: int,
    frame_index: int,
    extra: Dict[str, Any] | None = None,
):
    """Persist accumulation + RNG cursor (+ optional param pytree leaves)."""
    payload = {
        "version": np.int64(_FORMAT_VERSION),
        "linear": np.asarray(accum.linear),
        "frame": np.asarray(accum.frame),
        "seed": np.int64(seed),
        "frame_index": np.int64(frame_index),
    }
    for k, v in (extra or {}).items():
        payload[f"extra:{k}"] = np.asarray(v)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:  # file object: savez won't append .npz
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic swap


def load_render_state(path: str):
    """Load → (AccumState, seed, frame_index, extra dict)."""
    if not os.path.exists(path):
        raise CheckpointError(f"no checkpoint at {path}")
    with np.load(path) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise CheckpointError(f"unsupported checkpoint version {int(z['version'])}")
        accum = AccumState(
            linear=jnp.asarray(z["linear"]), frame=jnp.asarray(z["frame"])
        )
        extra = {
            k.split(":", 1)[1]: jnp.asarray(z[k]) for k in z.files if k.startswith("extra:")
        }
        return accum, int(z["seed"]), int(z["frame_index"]), extra
