"""The device a measurement runs on, and the persistent compile cache.

Used by `chip_smoke.py`, `bench.py` and ``python -m ptre.cli bench``: each
names the device it measured (platform, device kind, count, and the card's
name and power limit) and refuses to run without a GPU rather than time the
CPU under a device metric's name.
"""

from __future__ import annotations

import os
import subprocess

import jax

#: repository root; the compile cache lives under it unless
#: ``JAX_COMPILATION_CACHE_DIR`` says otherwise
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Keep JAX's persistent compilation cache at a fixed path.

    If ``JAX_COMPILATION_CACHE_DIR`` is set JAX already uses it and nothing
    is set here; otherwise the cache is ``<repo>/.jax_cache``. Returns the
    directory in use.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> None:
    """Exit nonzero unless JAX's first device is a GPU."""
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's first device is on platform {platform!r}; this "
            "measures the card and has no CPU fallback")


def device_info() -> dict:
    """Platform, device kind and count of JAX's devices."""
    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of each card, one per line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def peak_bytes() -> int | None:
    """``peak_bytes_in_use`` of the first device (None where not reported)."""
    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")
