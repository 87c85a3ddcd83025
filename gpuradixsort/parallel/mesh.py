"""Device-mesh helpers — the multi-device scale-out substrate.

The reference is single-device (SURVEY.md §2c: no NCCL/MPI, one GL context);
its only "hierarchy" is work-group scan -> scan-of-group-sums.  This engine
generalizes that hierarchy one level up: the GPUs of a host, joined all to
all by NVLink, form a ``jax.sharding.Mesh`` and exchange data with XLA
collectives (NCCL).  Every card reaches every other at the same rate, so the
mesh is one flat 1-D axis ("x") that shards rows; the exchange
(``dist_sort._shard_exchange_sorted``) rides ``lax.all_to_all`` over it.
"""

from __future__ import annotations

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

ROW_AXIS = "x"


def shard_rows(mesh: Mesh, *arrays):
    """Place arrays with rows sharded over the mesh axis.

    Committing inputs to the row sharding before ``dist_*`` calls avoids an
    implicit host->device relayout inside the first collective step.
    """
    sharding = NamedSharding(mesh, P(ROW_AXIS))
    out = tuple(jax.device_put(a, sharding) for a in arrays)
    return out[0] if len(out) == 1 else out


def make_row_mesh(num_devices: int | None = None) -> Mesh:
    """A 1-D mesh over the first ``num_devices`` devices, axis name "x"."""
    devices = jax.devices()
    if num_devices is None:
        num_devices = len(devices)
    if num_devices > len(devices):
        raise ValueError(
            f"requested {num_devices} devices, have {len(devices)}"
        )
    return jax.make_mesh((num_devices,), (ROW_AXIS,), devices=devices[:num_devices])
