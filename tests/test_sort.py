"""Radix-sort pipeline vs. np.sort/np.argsort oracles.

Covers the reference's own verification regime and upgrades it (SURVEY.md §4):
the shuffled 0..N-1 permutation oracle of ``main.cpp:120-125`` (sorted output
must be exactly arange), the 16-element hand-traceable fixture of
``main.cpp:127-143``, plus property classes the reference never tested:
random, presorted, reverse, all-equal, skewed, and duplicate-heavy keys.
"""

import numpy as np
import pytest

from gpuradixsort.config import EngineConfig, REFERENCE_PARITY_CONFIG
from gpuradixsort.core.table import make_key_column, table_from_arrays
from gpuradixsort.ops.sort import (
    METHODS,
    resolve_method,
    sort_keys,
    sort_pairs,
    sort_table,
)

CFG = EngineConfig()


def _keysets(rng, n):
    return {
        "permutation": rng.permutation(n).astype(np.uint32),
        "random32": rng.integers(0, 2**32, size=n, dtype=np.uint32),
        "presorted": np.arange(n, dtype=np.uint32),
        "reverse": np.arange(n, dtype=np.uint32)[::-1].copy(),
        "all_equal": np.full(n, 0xDEADBEEF, dtype=np.uint32),
        "skewed": (rng.zipf(1.5, size=n) % (2**32)).astype(np.uint32),
        "few_values": rng.integers(0, 4, size=n, dtype=np.uint32),
        "max_keys": np.where(
            rng.integers(0, 2, size=n).astype(bool),
            np.uint32(0xFFFFFFFF),
            rng.integers(0, 100, size=n, dtype=np.uint32),
        ),
    }


@pytest.mark.parametrize("n", [16, 1000, 4096, 10_000])
def test_sort_keys_matches_np_sort(n, rng):
    for name, keys in _keysets(rng, n).items():
        out = sort_keys(make_key_column(keys, CFG), CFG)
        np.testing.assert_array_equal(
            out.to_numpy(), np.sort(keys), err_msg=f"keyset={name} n={n}"
        )


def test_shuffled_permutation_oracle(rng):
    # The reference's oracle: input is a shuffled permutation of 0..N-1, so
    # sorted output is exactly [0, 1, ..., N-1] (ParallelSort.cpp:347).
    n = 100_000
    keys = rng.permutation(n).astype(np.uint32)
    out = sort_keys(make_key_column(keys, CFG), CFG)
    np.testing.assert_array_equal(out.to_numpy(), np.arange(n, dtype=np.uint32))


def test_hand_fixture_16():
    # Mirror of the commented-out 16-element debug dataset idea
    # (main.cpp:127-143): small enough to trace each pass by hand.
    keys = np.array(
        [3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3], dtype=np.uint32
    )
    sorted_col, perm = sort_pairs(make_key_column(keys, CFG), CFG)
    np.testing.assert_array_equal(sorted_col.to_numpy(), np.sort(keys))
    # Stability: equal keys keep original relative order == np.argsort stable.
    np.testing.assert_array_equal(
        perm.to_numpy(), np.argsort(keys, kind="stable").astype(np.uint32)
    )


@pytest.mark.parametrize("n", [16, 1000, 5000])
def test_sort_pairs_stability(n, rng):
    keys = rng.integers(0, 8, size=n, dtype=np.uint32)  # heavy duplicates
    _, perm = sort_pairs(make_key_column(keys, CFG), CFG)
    np.testing.assert_array_equal(
        perm.to_numpy(), np.argsort(keys, kind="stable").astype(np.uint32)
    )


def test_one_bit_reference_parity_mode(rng):
    # The 32x1-bit configuration — structurally the reference pipeline
    # (ParallelSort.cpp:236-298) — must agree with the multi-bit default.
    n = 3000
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    a = sort_keys(make_key_column(keys, REFERENCE_PARITY_CONFIG),
                  REFERENCE_PARITY_CONFIG, method="radix")
    b = sort_keys(make_key_column(keys, CFG), CFG, method="radix")
    np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())
    np.testing.assert_array_equal(a.to_numpy(), np.sort(keys))


def test_radix_widths_agree(rng):
    n = 2048
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    expected = np.sort(keys)
    for bits in (1, 2, 4, 8):
        cfg = EngineConfig(radix_bits=bits)
        out = sort_keys(make_key_column(keys, cfg), cfg, method="radix")
        np.testing.assert_array_equal(
            out.to_numpy(), expected, err_msg=f"radix_bits={bits}"
        )


def test_xla_method_agrees(rng):
    n = 5000
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    a = sort_keys(make_key_column(keys, CFG), CFG, method="radix")
    b = sort_keys(make_key_column(keys, CFG), CFG, method="xla")
    np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())


def test_sort_table_payload_permutation(rng):
    # Key + payload rows: the OriginalData record sort (SortOriginalData.comp).
    n = 4000
    keys = rng.integers(0, 1000, size=n, dtype=np.uint32)
    payload = rng.integers(0, 2**31, size=(n, 16)).astype(np.int32)  # 64B rows
    tbl = table_from_arrays(CFG, key=keys.astype(np.uint32), payload=payload)
    tbl = tbl.with_column("key", make_key_column(keys, CFG))
    out = sort_table(tbl, "key", CFG)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(out["key"].to_numpy(), keys[order])
    np.testing.assert_array_equal(out["payload"].to_numpy(), payload[order])


@pytest.mark.parametrize("n", [1, 127, 128, 129, 1023, 1024, 1025])
def test_ragged_sizes(n, rng):
    # Padding rule: round up to tile multiple with 0xffffffff sentinels
    # (PrefixSumSsbo.cpp:102-104; OriginalDataToIntermediateData.comp:44-47).
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    out = sort_keys(make_key_column(keys, CFG), CFG)
    np.testing.assert_array_equal(out.to_numpy(), np.sort(keys))


class TestRadix8:
    """8-bit digits: wide (T, 256) histogram/offset tables, 4 passes."""

    def test_sort_matches_np(self, rng):
        cfg8 = EngineConfig(radix_bits=8)
        assert cfg8.num_passes == 4 and cfg8.radix == 256
        n = 5000
        for name, keys in _keysets(rng, n).items():
            out = sort_keys(make_key_column(keys, cfg8), cfg8, method="radix")
            np.testing.assert_array_equal(
                out.to_numpy(), np.sort(keys), err_msg=f"keyset={name}"
            )

    def test_pairs_stability(self, rng):
        cfg8 = EngineConfig(radix_bits=8)
        keys = rng.integers(0, 300, size=4000, dtype=np.uint32)
        _, perm = sort_pairs(make_key_column(keys, cfg8), cfg8, method="radix")
        np.testing.assert_array_equal(
            perm.to_numpy(), np.argsort(keys, kind="stable").astype(np.uint32)
        )

    def test_agrees_with_radix4(self, rng):
        keys = rng.integers(0, 2**32, size=3000, dtype=np.uint32)
        cfg8 = EngineConfig(radix_bits=8)
        a = sort_keys(make_key_column(keys, cfg8), cfg8, method="radix")
        b = sort_keys(make_key_column(keys, CFG), CFG, method="radix")
        np.testing.assert_array_equal(a.to_numpy(), b.to_numpy())


KEYSETS = sorted(_keysets(np.random.default_rng(0), 1))


@pytest.mark.parametrize("keyset", KEYSETS)
@pytest.mark.parametrize("method", METHODS)
def test_methods_match_numpy(method, keyset):
    # Every remaining method, on every keyset class, for keys, pairs and the
    # stable permutation; n is ragged so pad rows are in play.
    n = 3001
    keys = _keysets(np.random.default_rng(7), n)[keyset]
    out = sort_keys(make_key_column(keys, CFG), CFG, method=method)
    np.testing.assert_array_equal(out.to_numpy(), np.sort(keys))
    s, perm = sort_pairs(make_key_column(keys, CFG), CFG, method=method)
    np.testing.assert_array_equal(s.to_numpy(), np.sort(keys))
    np.testing.assert_array_equal(
        perm.to_numpy(), np.argsort(keys, kind="stable").astype(np.uint32)
    )


@pytest.mark.parametrize(
    "method,resolved", [("auto", "xla"), ("radix", "radix"), ("xla", "xla")]
)
def test_resolve_method(method, resolved):
    assert resolve_method(method) == resolved


@pytest.mark.parametrize("method", ["fused", "bogus"])
def test_unknown_method_raises(method):
    # "fused" (the removed window-writer pipeline) is no longer a method.
    from gpuradixsort.parallel.dist_sort import dist_sort_pairs
    from gpuradixsort.parallel.mesh import make_row_mesh

    keys = np.arange(100, dtype=np.uint32)
    with pytest.raises(ValueError, match="unknown sort method"):
        sort_keys(keys, CFG, method=method)
    with pytest.raises(ValueError, match="unknown sort method"):
        sort_pairs(keys, CFG, method=method)
    with pytest.raises(ValueError, match="unknown sort method"):
        dist_sort_pairs(
            np.zeros(2 * CFG.block, np.uint32), make_row_mesh(2), CFG,
            method=method,
        )
