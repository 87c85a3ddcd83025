"""Distributed aggregate / join on the virtual 8-device CPU mesh vs numpy."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpuradixsort.config import PAD_KEY, EngineConfig
from gpuradixsort.core.table import pad_to_tile, round_up
from gpuradixsort.parallel.dist_ops import (
    dist_group_by_aggregate,
    dist_join_inner,
    gather_groups,
    gather_join,
)
from gpuradixsort.parallel.mesh import make_row_mesh

CFG = EngineConfig()


def _pad_for_mesh(arr, num_shards, fill):
    n = round_up(arr.shape[0], num_shards * CFG.block)
    out = np.full((n,), fill, arr.dtype)
    out[: arr.shape[0]] = arr
    return jnp.asarray(out)


@pytest.mark.parametrize("num_shards", [4, 8])
def test_dist_aggregate_matches_numpy(rng, num_shards):
    n = 40_000
    keys = rng.integers(0, 500, n, dtype=np.uint32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    mesh = make_row_mesh(num_shards)
    res = dist_group_by_aggregate(
        _pad_for_mesh(keys, num_shards, np.uint32(PAD_KEY)),
        {"v": _pad_for_mesh(vals, num_shards, np.int32(0))},
        {"s": ("v", "sum"), "c": ("v", "count"), "mx": ("v", "max")},
        mesh,
        CFG,
        n_live=n,
    )
    out_k, out_v = gather_groups(res)
    uniq = np.unique(keys)
    np.testing.assert_array_equal(out_k, uniq)
    np.testing.assert_array_equal(
        out_v["s"], [vals[keys == g].sum(dtype=np.int32) for g in uniq]
    )
    np.testing.assert_array_equal(
        out_v["c"], [(keys == g).sum() for g in uniq]
    )
    np.testing.assert_array_equal(
        out_v["mx"], [vals[keys == g].max() for g in uniq]
    )


def test_dist_aggregate_skewed_autoretry(rng):
    # One dominant key: the receiving shard overflows at default slack and
    # auto-retry must recover.
    n = 40_000
    keys = np.where(
        rng.random(n) < 0.9, np.uint32(42),
        rng.integers(0, 2**32, n).astype(np.uint32),
    )
    vals = np.ones(n, np.int32)
    mesh = make_row_mesh(4)
    res = dist_group_by_aggregate(
        _pad_for_mesh(keys, 4, np.uint32(PAD_KEY)),
        {"v": _pad_for_mesh(vals, 4, np.int32(0))},
        {"c": ("v", "sum")},
        mesh,
        CFG,
        n_live=n,
    )
    out_k, out_v = gather_groups(res)
    uniq = np.unique(keys)
    np.testing.assert_array_equal(out_k, uniq)
    np.testing.assert_array_equal(
        out_v["c"], [(keys == g).sum() for g in uniq]
    )


@pytest.mark.parametrize("num_shards", [4, 8])
def test_dist_join_matches_numpy(rng, num_shards):
    n_p, n_b = 20_000, 10_000
    pk = rng.integers(0, 300, n_p, dtype=np.uint32)
    bk = rng.integers(0, 300, n_b, dtype=np.uint32)  # duplicates on both
    pv = rng.integers(0, 2**31, n_p).astype(np.uint32)
    bv = rng.integers(0, 2**31, n_b).astype(np.uint32)
    mesh = make_row_mesh(num_shards)
    res = dist_join_inner(
        _pad_for_mesh(pk, num_shards, np.uint32(PAD_KEY)),
        _pad_for_mesh(pv, num_shards, np.uint32(0)),
        _pad_for_mesh(bk, num_shards, np.uint32(PAD_KEY)),
        _pad_for_mesh(bv, num_shards, np.uint32(0)),
        mesh,
        CFG,
        join_cap_factor=8.0,
        n_probe=n_p,
        n_build=n_b,
    )
    k, opv, obv = gather_join(res)
    # Oracle: all (probe, build) matched pairs, as a multiset.
    order = np.argsort(bk, kind="stable")
    bk_s, bv_s = bk[order], bv[order]
    want = []
    for i in range(n_p):
        lo = np.searchsorted(bk_s, pk[i], side="left")
        hi = np.searchsorted(bk_s, pk[i], side="right")
        want.extend((int(pk[i]), int(pv[i]), int(bv_s[j])) for j in range(lo, hi))
    got = list(zip(k.tolist(), opv.tolist(), obv.tolist()))
    assert len(got) == len(want)
    assert sorted(got) == sorted(want)
    # Global key-ordering contract.
    assert np.all(np.diff(k.astype(np.int64)) >= 0)


def test_dist_join_no_matches(rng):
    n = 8_192
    pk = rng.integers(0, 100, n, dtype=np.uint32)
    bk = rng.integers(1000, 1100, n, dtype=np.uint32)
    v = np.zeros(n, np.uint32)
    mesh = make_row_mesh(4)
    res = dist_join_inner(
        _pad_for_mesh(pk, 4, np.uint32(PAD_KEY)),
        _pad_for_mesh(v, 4, np.uint32(0)),
        _pad_for_mesh(bk, 4, np.uint32(PAD_KEY)),
        _pad_for_mesh(v, 4, np.uint32(0)),
        mesh,
        CFG,
        n_probe=n,
        n_build=n,
    )
    k, _, _ = gather_join(res)
    assert k.size == 0
