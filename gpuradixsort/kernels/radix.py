"""Per-pass radix-sort primitives: digit histograms and stable destinations.

Reference equivalents, redesigned rather than translated:

- ``GetBitForPrefixScan.comp`` (extract 1 bit per element) + the per-group
  half of ``ParallelPrefixScan.comp`` fuse into one per-tile histogram: each
  tile one-hot-expands its digits and reduces, producing a full R-bucket
  histogram per tile in a single pass — multi-bit digits instead of the
  reference's 1-bit-x-32-pass GLSL workaround.
- ``SortIntermediateData.comp:42-62`` computes each element's destination as
  ``group offset + within-group rank``; ``tile_destinations`` below is the
  same factorization: global (digit, tile) offset table + within-tile stable
  rank, computed with a cumsum over the one-hot expansion.

The cross-tile offset table (the reference's scan-of-group-sums dispatch,
``ParallelPrefixScan.comp:151-196``) is tiny ((num_tiles, R) int32) and is
computed with jnp cumsums in ``global_offsets``.

These are plain jnp functions that XLA compiles for whatever backend runs
them; a tile is ``cfg.tile`` consecutive elements of a flat key array whose
length is a multiple of the tile.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gpuradixsort.config import EngineConfig


def _tile_digits(keys: jax.Array, shift: int, cfg: EngineConfig) -> jax.Array:
    """(num_tiles, tile) int32 digits (keys >> shift) & (radix - 1)."""
    digits = jax.lax.shift_right_logical(keys, jnp.uint32(shift)).astype(
        jnp.int32
    ) & jnp.int32(cfg.radix - 1)
    return digits.reshape(-1, cfg.tile)


def _one_hot(digits: jax.Array, cfg: EngineConfig) -> jax.Array:
    return (
        digits[:, :, None] == jnp.arange(cfg.radix, dtype=jnp.int32)
    ).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("shift", "cfg"))
def tile_histograms(keys: jax.Array, shift: int, cfg: EngineConfig) -> jax.Array:
    """Per-tile digit histograms.

    keys: (num_tiles * cfg.tile,) uint32.  Returns (num_tiles, cfg.radix)
    int32 with hist[t, r] = number of keys in tile t whose digit is r.
    """
    digits = _tile_digits(keys, shift, cfg)
    return jnp.sum(_one_hot(digits, cfg), axis=1, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("shift", "cfg"))
def tile_destinations(
    keys: jax.Array, offsets: jax.Array, shift: int, cfg: EngineConfig
) -> jax.Array:
    """Stable global destination index for every element.

    keys: (num_tiles * cfg.tile,) uint32; offsets: (num_tiles, cfg.radix)
    int32 global base offsets from ``global_offsets``.  Returns
    (num_tiles * cfg.tile,) int32 destinations — a permutation of 0..N-1:
    dest[i] = offsets[tile, digit_i] + (# of j < i in this tile with the same
    digit), the stable-scatter index rule of ``SortIntermediateData.comp:
    42-62`` generalized to multi-bit digits.
    """
    digits = _tile_digits(keys, shift, cfg)
    one_hot = _one_hot(digits, cfg)
    rank = jnp.cumsum(one_hot, axis=1) - one_hot  # exclusive, per tile/bucket
    my_rank = jnp.take_along_axis(rank, digits[:, :, None], axis=2)[..., 0]
    my_base = jnp.take_along_axis(offsets, digits, axis=1)
    return (my_base + my_rank).reshape(-1).astype(jnp.int32)


def global_offsets(hist: jax.Array) -> jax.Array:
    """(num_tiles, R) histograms -> (num_tiles, R) global offsets.

    Stable LSD ordering is digit-major, then tile-major: bucket r starts after
    every element of buckets < r (all tiles), plus the same bucket in earlier
    tiles.  This is the scan-of-group-sums of ``ParallelPrefixScan.comp:
    151-196`` plus the ``PrefixSumsByGroup[wg]`` offset of
    ``SortIntermediateData.comp:42-44``, folded into one table.
    """
    col_totals = jnp.sum(hist, axis=0)  # (R,)
    digit_base = jnp.cumsum(col_totals) - col_totals  # exclusive over digits
    tile_excl = jnp.cumsum(hist, axis=0) - hist  # exclusive over tiles
    return (digit_base[None, :] + tile_excl).astype(jnp.int32)
