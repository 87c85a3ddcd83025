"""Distributed sort over a virtual 8-device CPU mesh (SURVEY.md §4.6).

The reference has no multi-device story; this is the scale-out design tested
the way CI must test it: XLA's virtual-device simulation, so the partition /
all_to_all / merge logic runs without several GPUs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gpuradixsort.config import PAD_KEY, EngineConfig
from gpuradixsort.core.table import pad_to_tile, round_up
from gpuradixsort.parallel.dist_sort import dist_sort_pairs, gather_sorted
from gpuradixsort.parallel.mesh import make_row_mesh

CFG = EngineConfig()


def _pad_for_mesh(keys: np.ndarray, num_shards: int) -> jnp.ndarray:
    n = keys.shape[0]
    padded = round_up(n, num_shards * CFG.block)
    out = np.full(padded, np.uint32(PAD_KEY), dtype=np.uint32)
    out[:n] = keys
    return jnp.asarray(out)


def _check(keys: np.ndarray, num_shards: int, **kw):
    from gpuradixsort.parallel.mesh import shard_rows

    n = keys.shape[0]
    mesh = make_row_mesh(num_shards)
    padded = shard_rows(mesh, _pad_for_mesh(keys, num_shards))
    res = dist_sort_pairs(padded, mesh, CFG, n_live=n, **kw)
    out_keys, out_idx = gather_sorted(res)
    np.testing.assert_array_equal(out_keys[:n], np.sort(keys))
    # Stability: indices are the stable argsort (pads carry idx >= n and
    # sit at the very end).
    np.testing.assert_array_equal(
        out_idx[:n], np.argsort(keys, kind="stable").astype(np.uint32)
    )


@pytest.mark.parametrize("num_shards", [2, 4, 8])
def test_dist_sort_random(num_shards, rng):
    keys = rng.integers(0, 2**32, size=50_000, dtype=np.uint32)
    _check(keys, num_shards)


def test_dist_sort_permutation_oracle(rng):
    n = 100_000
    keys = rng.permutation(n).astype(np.uint32)
    mesh = make_row_mesh(8)
    res = dist_sort_pairs(_pad_for_mesh(keys, 8), mesh, CFG, n_live=n)
    out_keys, _ = gather_sorted(res)
    np.testing.assert_array_equal(out_keys[:n], np.arange(n, dtype=np.uint32))


def test_dist_sort_duplicates_and_stability(rng):
    keys = rng.integers(0, 16, size=30_000, dtype=np.uint32)
    _check(keys, 4)


def test_dist_sort_max_keys(rng):
    # Real 0xFFFFFFFF keys must precede pad sentinels (stability repair).
    keys = np.where(
        rng.integers(0, 2, size=20_000).astype(bool),
        np.uint32(0xFFFFFFFF),
        rng.integers(0, 1000, size=20_000, dtype=np.uint32),
    )
    _check(keys, 4)


def test_dist_sort_skewed(rng):
    # 90% of keys in one narrow range: midpoint bucket assignment must
    # rebalance; capacity slack absorbs the rest.
    a = rng.integers(0, 1000, size=45_000, dtype=np.uint32)
    b = rng.integers(0, 2**32, size=5_000, dtype=np.uint32)
    keys = np.concatenate([a, b])
    rng.shuffle(keys)
    _check(keys, 4, cap_factor=3.0)


def test_dist_sort_overflow_flag():
    # All keys identical: one bucket = the whole dataset; with slack < P the
    # receiving shard overflows and must say so when auto-retry is off.
    keys = np.full(40_000, 12345, dtype=np.uint32)
    mesh = make_row_mesh(4)
    res = dist_sort_pairs(
        _pad_for_mesh(keys, 4), mesh, CFG, cap_factor=1.5, n_live=len(keys),
        auto_retry=False,
    )
    assert bool(res.overflow)
    with pytest.raises(RuntimeError, match="overflow"):
        gather_sorted(res)
    # With enough slack it succeeds.
    res2 = dist_sort_pairs(
        _pad_for_mesh(keys, 4), mesh, CFG, cap_factor=4.8, n_live=len(keys)
    )
    assert not bool(res2.overflow)
    out_keys, _ = gather_sorted(res2)
    np.testing.assert_array_equal(out_keys[: len(keys)], np.sort(keys))


def test_dist_sort_all_equal_untuned():
    # Auto-retry doubles cap_factor until the worst case fits: an all-equal
    # keyset succeeds with default parameters.
    keys = np.full(40_000, 7, dtype=np.uint32)
    mesh = make_row_mesh(4)
    res = dist_sort_pairs(
        _pad_for_mesh(keys, 4), mesh, CFG, n_live=len(keys)
    )
    assert not bool(res.overflow)
    out_keys, out_idx = gather_sorted(res)
    np.testing.assert_array_equal(out_keys[: len(keys)], keys)
    # Stability: the all-equal permutation must be the identity.
    np.testing.assert_array_equal(
        out_idx[: len(keys)], np.arange(len(keys), dtype=np.uint32)
    )


def test_dist_matches_single_chip(rng):
    from gpuradixsort.core.table import make_key_column
    from gpuradixsort.ops.sort import sort_keys

    keys = rng.integers(0, 2**20, size=40_000, dtype=np.uint32)
    single = sort_keys(make_key_column(keys, CFG), CFG).to_numpy()
    mesh = make_row_mesh(8)
    out_keys, _ = gather_sorted(
        dist_sort_pairs(_pad_for_mesh(keys, 8), mesh, CFG, n_live=len(keys))
    )
    np.testing.assert_array_equal(out_keys[: len(keys)], single)


def test_dist_sort_narrow_key_range(rng):
    # Regression: with a narrow observed key range the pad keys' bucket id
    # exceeded int32 and wrapped to bucket 0, scrambling the partition
    # (fixed by clamping in uint32 before the cast).
    keys = rng.integers(0, 5, size=40_000, dtype=np.uint32)
    _check(keys, 4)
    _check(keys, 8)


@pytest.mark.parametrize("num_shards", [3, 8])
def test_dist_sort_overlap_ring(num_shards, rng):
    # The ring schedule (ppermute + merge-as-you-receive) must be
    # semantically identical to the all_to_all + merge tree, including on a
    # non-power-of-two mesh (the tree path cannot even run there).
    keys = rng.integers(0, 2**32, size=48_000, dtype=np.uint32)
    _check(keys, num_shards, overlap=True)


def test_dist_sort_overlap_stability(rng):
    # Heavy duplicates: cyclic (non-rank-monotone) arrival order must not
    # perturb equal-key order — the (key, gidx) composite fold guarantees it.
    keys = rng.integers(0, 8, size=30_000, dtype=np.uint32)
    _check(keys, 4, overlap=True)


def test_dist_sort_overlap_max_keys(rng):
    # Real 0xFFFFFFFF keys tie with pad sentinels on the key; the gidx
    # tiebreak must keep every live row inside the truncated accumulator.
    keys = np.where(
        rng.integers(0, 2, size=20_000).astype(bool),
        np.uint32(0xFFFFFFFF),
        rng.integers(0, 1000, size=20_000, dtype=np.uint32),
    )
    _check(keys, 4, overlap=True)
