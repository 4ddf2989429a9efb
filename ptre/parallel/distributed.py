"""Multi-host bootstrap + global-mesh helpers.

The reference is single-process single-GPU (SURVEY §5 "Distributed
communication backend: none"); the scaling design targets several hosts
(BASELINE north star: ≥85% scaling efficiency at N≥2 hosts). This module is
the bootstrap layer:

  * `initialize()` wraps `jax.distributed.initialize` — call it FIRST, before
    any backend touch, on every process of the job. On GPU hosts nothing is
    detected for you: pass the coordinator address (``host:port``), the
    number of processes and this process's id explicitly or via the
    standard env vars. Multi-host runs are exercised only on CPU processes
    over localhost (`tests/test_multihost.py`).
  * `global_mesh()` builds a ("dp", "sp") mesh over ALL processes' devices —
    the (hosts × local devices) mesh the render/train steps shard over. The
    per-device program is unchanged from single-host (`parallel.sharding`);
    only the mesh grows, and XLA routes the psums through the collective
    library (NCCL on GPUs).
  * `make_global_array()` / `replicate_global()` place process-local numpy
    data as jax.Arrays sharded/replicated over a global mesh (each process
    provides only its addressable shards).

Validated end-to-end by `tests/test_multihost.py`, which spawns real
multi-process jobs over localhost and checks the sharded render and the
psum'd gradients match the single-process result bit-for-bit.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ptre.parallel import sharding as _sh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bootstrap the jax.distributed runtime for a multi-host job.

    Must run before the first backend use in every process. Arguments
    default to the standard env vars (``JAX_COORDINATOR_ADDRESS``,
    ``JAX_NUM_PROCESSES``, ``JAX_PROCESS_ID``); all three are required.
    No-ops if the distributed client is already connected.
    """
    # NB: jax.process_count() would itself initialize the backend, which
    # must not happen before jax.distributed.initialize — inspect the
    # distributed client state directly instead.
    from jax._src import distributed as _jdist

    if getattr(_jdist.global_state, "client", None) is not None:
        return  # already initialized
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        # single-host run with no distributed config: nothing to do
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def is_multihost() -> bool:
    return jax.process_count() > 1


def global_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """("dp", "sp") mesh over the GLOBAL device set (all hosts).

    Defaults to (total_devices, 1) — pure pixel-row data parallelism, the
    zero-communication forward layout. The mesh device order groups each
    host's local devices contiguously, so a ``dp`` psum reduces within
    hosts before crossing hosts.
    """
    return _sh.make_mesh(shape, devices=jax.devices())


def make_global_array(mesh: Mesh, spec: P, full_shape, local_lookup) -> jax.Array:
    """Build a global jax.Array on ``mesh`` from per-shard numpy data.

    ``local_lookup(index)`` maps a global index (tuple of slices) to the
    numpy block for that shard; it is only called for this process's
    addressable devices. For data small enough to exist fully on every host,
    pass ``lambda idx: full[idx]``.
    """
    sharding = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(tuple(full_shape), sharding, local_lookup)


def replicate_global(mesh: Mesh, tree):
    """Replicate a pytree of host-resident arrays over a (possibly
    multi-host) mesh — the scene-packet/camera placement."""

    def put(x):
        x = np.asarray(x)
        if x.ndim == 0:
            x = x[None]  # 0-d arrays: make_array_from_callback wants shapes
            arr = make_global_array(mesh, P(), x.shape, lambda idx: x[idx])
            return arr.reshape(())
        return make_global_array(mesh, P(), x.shape, lambda idx: x[idx])

    return jax.tree.map(put, tree)


def shard_rows_global(mesh: Mesh, arr) -> jax.Array:
    """Row-shard an (H, ...) host array over the global dp axis."""
    arr = np.asarray(arr)
    return make_global_array(mesh, P("dp"), arr.shape, lambda idx: arr[idx])


def process_local_rows(mesh: Mesh, global_rows: int) -> Tuple[int, int]:
    """The [start, stop) row range this process owns under P("dp") sharding."""
    dp = mesh.shape["dp"]
    rows = global_rows // dp
    local = [d for d in mesh.devices.flat if d.process_index == jax.process_index()]
    starts = sorted(
        {np.where(mesh.devices == d)[0][0] * rows for d in local}
    )
    return int(starts[0]), int(starts[-1] + rows)
