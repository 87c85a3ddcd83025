"""Multi-host runtime: process init + host-aware mesh layout.

The reference is a single-process, single-GPU demo (SURVEY.md §2c — no
NCCL/MPI, one GL context); its scale story ends at one device.  Here the
scale-out substrate is N hosts, each driving its local GPUs, joined by
`jax.distributed` into one logical runtime.  Within a host the cards are
joined all to all by NVLink; between hosts collectives cross the network.

Two pieces live here:

- :func:`initialize` — the `jax.distributed.initialize` entry point.  The
  coordinator address, process count and process id come from the
  arguments or from ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
  ``JAX_PROCESS_ID``; with no coordinator it is a documented no-op, so
  driver code can call it unconditionally.
- :func:`make_pod_mesh` — a mesh whose *outer* axis spans hosts (network)
  and *inner* axis spans each host's local devices (NVLink).  Collectives
  over the inner axis never leave the host, so bandwidth-hungry exchanges
  (the radix `all_to_all`) should use the inner axis, and only the
  low-volume levels of the hierarchy (global bucket histograms via `psum`,
  splitter agreement) should touch the outer axis.  This is the N-level
  generalization of the reference's two-level scan (work-group scan ->
  scan-of-group-sums, ``ParallelPrefixScan.comp:93-104``): tile -> device ->
  host.

`dist_sort` / `dist_ops` operate over a 1-D row axis; :func:`flatten_pod_mesh`
produces that axis host-major, so shard rank order == (host, local device)
order and the stable source-major merge contract is preserved across hosts.
"""

from __future__ import annotations

import os

import jax
import numpy as np
from jax.sharding import Mesh

from gpuradixsort.parallel.mesh import ROW_AXIS

HOST_AXIS = "host"

_initialized = False


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join (or create) the multi-process JAX runtime.  Idempotent.

    Returns True if `jax.distributed.initialize` was actually called, False
    for the single-process no-op.  Arguments left as None are read from
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``.
    """
    global _initialized
    if _initialized:
        return True
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    env_np = os.environ.get("JAX_NUM_PROCESSES")
    num_processes = (
        num_processes if num_processes is not None
        else (int(env_np) if env_np else None)
    )
    env_pid = os.environ.get("JAX_PROCESS_ID")
    process_id = (
        process_id if process_id is not None
        else (int(env_pid) if env_pid else None)
    )
    if coordinator_address is None:
        # Single-process run (tests, one-host benches): nothing to join.
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    _initialized = True
    return True


def make_pod_mesh(devices=None) -> Mesh:
    """2-D (host, device) mesh: outer axis across hosts, inner within one.

    Single-process runs (including the virtual-device CPU simulation) get a
    (1, num_devices) mesh, so code written against the two axes runs
    unchanged from laptop CI to a multi-host cluster.
    """
    if devices is None:
        devices = jax.devices()
    per_host = jax.local_device_count()
    num_hosts = len(devices) // per_host
    if num_hosts * per_host != len(devices):
        raise ValueError(
            f"{len(devices)} devices do not split evenly over "
            f"{per_host}-device hosts"
        )
    # Host-major order: devices[i] for process p occupy rows of the grid.
    grid = np.asarray(devices).reshape(num_hosts, per_host)
    return Mesh(grid, (HOST_AXIS, ROW_AXIS))


def flatten_pod_mesh(mesh: Mesh) -> Mesh:
    """Collapse a (host, device) mesh to the 1-D row mesh dist_* expects.

    The flat axis is host-major, so shard ranks are contiguous within a host:
    the range-partitioner's contiguous bucket->shard assignment then keeps
    most exchange volume between neighboring ranks on the same host's
    NVLink, with only range-boundary traffic crossing the network.
    """
    return Mesh(mesh.devices.reshape(-1), (ROW_AXIS,))
