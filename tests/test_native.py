"""Native host runtime (ctypes C++ library) vs numpy equivalents."""

import numpy as np

from gpuradixsort.utils import native


def test_shuffled_permutation_roundtrip():
    k = native.shuffled_permutation(10_000, seed=3)
    assert sorted(k.tolist()) == list(range(10_000))


def test_radix_oracle_stable(rng):
    keys = rng.integers(0, 50, size=20_000, dtype=np.uint32)
    sk, si = native.radix_sort_pairs(keys)
    np.testing.assert_array_equal(sk, np.sort(keys))
    np.testing.assert_array_equal(
        si, np.argsort(keys, kind="stable").astype(np.uint32)
    )


def test_first_unsorted():
    assert native.first_unsorted(np.array([1, 2, 3], np.uint32)) == -1
    assert native.first_unsorted(np.array([1, 3, 2], np.uint32)) == 2
    assert native.first_unsorted(np.array([], np.uint32)) == -1


def test_random_keys_deterministic():
    a = native.random_keys(1000, seed=9)
    b = native.random_keys(1000, seed=9)
    np.testing.assert_array_equal(a, b)
