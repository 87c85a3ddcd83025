"""The radix pass primitives vs plain numpy, at every digit width.

``tile_histograms`` must equal a per-tile ``np.bincount`` of the digits, and
``tile_destinations`` must equal the destination a stable numpy sort by digit
gives each element; together they are one stable counting-sort pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from gpuradixsort.config import EngineConfig
from gpuradixsort.kernels import radix as rk
from gpuradixsort.ops import permute

BITS = [1, 2, 4, 8]


def _keys(cfg: EngineConfig, tiles: int = 3) -> np.ndarray:
    return np.random.default_rng(cfg.radix_bits).integers(
        0, 2**32, tiles * cfg.tile, dtype=np.uint32
    )


def _digits(keys: np.ndarray, shift: int, cfg: EngineConfig) -> np.ndarray:
    return ((keys >> np.uint32(shift)) & np.uint32(cfg.radix - 1)).astype(
        np.int64
    )


@pytest.mark.parametrize("bits", BITS)
def test_tile_histograms_match_bincount(bits):
    cfg = EngineConfig(radix_bits=bits)
    keys = _keys(cfg)
    shift = cfg.key_bits - bits  # the top digit
    hist = np.asarray(rk.tile_histograms(jnp.asarray(keys), shift, cfg))
    digits = _digits(keys, shift, cfg).reshape(-1, cfg.tile)
    want = np.stack([np.bincount(d, minlength=cfg.radix) for d in digits])
    assert hist.shape == (digits.shape[0], cfg.radix)
    np.testing.assert_array_equal(hist, want)


@pytest.mark.parametrize("bits", BITS)
def test_tile_destinations_match_stable_rank(bits):
    cfg = EngineConfig(radix_bits=bits)
    keys = _keys(cfg)
    dev = jnp.asarray(keys)
    offsets = rk.global_offsets(rk.tile_histograms(dev, 0, cfg))
    dest = np.asarray(rk.tile_destinations(dev, offsets, 0, cfg))
    # Element i lands where a stable sort by digit puts it.
    order = np.argsort(_digits(keys, 0, cfg), kind="stable")
    want = np.empty_like(order)
    want[order] = np.arange(order.shape[0])
    np.testing.assert_array_equal(dest, want)


def test_global_offsets_is_digit_major_then_tile_major():
    hist = jnp.asarray([[1, 2], [3, 4]], jnp.int32)
    # bucket 0: tile 0 at 0, tile 1 at 1; bucket 1 starts after all 4 zeros.
    np.testing.assert_array_equal(
        np.asarray(rk.global_offsets(hist)), [[0, 4], [1, 6]]
    )


def test_scatter_and_gather_are_inverse():
    rng = np.random.default_rng(9)
    dest = rng.permutation(1000).astype(np.int32)
    vals = rng.integers(0, 2**31, (1000, 3)).astype(np.int32)
    (out,) = permute.scatter_by_destination(jnp.asarray(dest), [vals])
    np.testing.assert_array_equal(np.asarray(out)[dest], vals)
    back = permute.gather_rows(out, jnp.asarray(dest))
    np.testing.assert_array_equal(np.asarray(back), vals)
