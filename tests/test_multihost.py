"""Multi-host runtime pieces, exercised single-process on the virtual mesh.

A real multi-host cluster cannot run in CI; what can is everything around
the `jax.distributed.initialize` call: the no-op path, the (host, device)
mesh construction, and that the flattened mesh drives the distributed sort
identically to the plain row mesh.
"""

import jax
import numpy as np

from gpuradixsort.config import EngineConfig
from gpuradixsort.parallel import multihost
from gpuradixsort.parallel.dist_sort import dist_sort_pairs, gather_sorted
from gpuradixsort.parallel.mesh import ROW_AXIS

CFG = EngineConfig()


def test_initialize_single_process_is_noop(monkeypatch):
    for var in (
        "JAX_COORDINATOR_ADDRESS",
        "JAX_NUM_PROCESSES",
        "JAX_PROCESS_ID",
    ):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False


def test_pod_mesh_shape_and_axes():
    mesh = multihost.make_pod_mesh()
    assert mesh.axis_names == (multihost.HOST_AXIS, ROW_AXIS)
    # Single process: one "host" spanning all local (virtual) devices.
    assert mesh.shape[multihost.HOST_AXIS] == 1
    assert mesh.shape[ROW_AXIS] == jax.local_device_count()


def test_flattened_pod_mesh_runs_dist_sort(rng):
    pod = multihost.make_pod_mesh()
    mesh = multihost.flatten_pod_mesh(pod)
    num_shards = mesh.shape[ROW_AXIS]
    n = num_shards * CFG.block * 4
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    res = dist_sort_pairs(jax.numpy.asarray(keys), mesh, CFG, n_live=n)
    out_keys, out_idx = gather_sorted(res)
    np.testing.assert_array_equal(out_keys, np.sort(keys))
    np.testing.assert_array_equal(
        out_idx, np.argsort(keys, kind="stable").astype(np.uint32)
    )
