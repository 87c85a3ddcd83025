"""Engine-wide configuration — the single-sourced constants module.

The reference keeps its kernel<->host contract in shared header files that are
#include-able from both C++ and GLSL (binding slots, uniform locations, and the
tile-size constants ``PARALLEL_SORT_WORK_GROUP_SIZE_X``/``ITEMS_PER_WORK_GROUP``;
see reference ``Shaders/ComputeHeaders/ParallelSortConstants.comp:17-24`` and
``Shaders/ComputeHeaders/SsboBufferBindings.comp:2-16``).  Here that contract
is this dataclass: tile size, digit width and padding granularity are defined
once and imported by every operator, so there is exactly one place where it
lives.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

# Padding granularity: a tile is ``tile_rows * LANES`` elements and columns
# are padded to ``TILES_PER_STEP`` tiles (8192 elements by default).  The
# distributed operators round their exchange capacities to the same block,
# so these values are part of the padding contract, not tuning knobs.
LANES = 128
TILES_PER_STEP = 8

# Sentinel key used to pad ragged tails up to a tile multiple.  Mirrors the
# reference, which pads the intermediate buffer tail with 0xffffffff so padding
# sorts to the back (``Shaders/ParallelSort/OriginalDataToIntermediateData.comp:44-47``).
PAD_KEY = jnp.uint32(0xFFFFFFFF)

# Sentinel original-row index carried by pad entries.  Real rows always have
# index < N <= 2**32 - 1, so the sentinel is distinguishable.
PAD_INDEX = jnp.uint32(0xFFFFFFFF)


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Tile size + radix parameters shared by every operator.

    Equivalent in role to the reference's ``ParallelSortConstants.comp``
    (work-group size 512, 1024 items per scan group): a tile is the unit
    over which digit histograms and within-tile ranks are computed, and the
    digit is ``radix_bits`` wide (the reference is hard-wired to 1 bit/pass
    x 32 passes as a GLSL workaround; multi-bit digits are the idiomatic
    form).
    """

    # Digit width per radix pass.  4 -> 16 buckets, 8 passes for uint32 keys.
    radix_bits: int = 4
    # Rows of LANES elements per tile.  tile = tile_rows * LANES elements.
    tile_rows: int = 8
    # Sort key bit-width (uint32 keys, as the reference's OriginalData._value).
    key_bits: int = 32

    def __post_init__(self):
        if self.key_bits % self.radix_bits != 0:
            raise ValueError(
                f"radix_bits={self.radix_bits} must divide key_bits={self.key_bits}"
            )
        if self.radix_bits not in (1, 2, 4, 8):
            raise ValueError("radix_bits must be one of (1, 2, 4, 8)")
        if self.tile_rows < 1:
            raise ValueError("tile_rows must be >= 1")

    @property
    def radix(self) -> int:
        """Number of digit buckets per pass (2**radix_bits)."""
        return 1 << self.radix_bits

    @property
    def tile(self) -> int:
        """Elements per tile (the ITEMS_PER_WORK_GROUP analog)."""
        return self.tile_rows * LANES

    @property
    def block(self) -> int:
        """Padding granularity in elements.

        Buffers are padded to a multiple of this, the analog of the
        reference's round-up-to-ITEMS_PER_WORK_GROUP rule
        (``PrefixSumSsbo.cpp:102-104``).
        """
        return self.tile * TILES_PER_STEP

    @property
    def num_passes(self) -> int:
        """LSD passes needed to cover the full key width."""
        return self.key_bits // self.radix_bits


# A 1-bit-per-pass configuration kept as a cross-check oracle: structurally the
# closest analog of the reference's 32x1-bit pipeline
# (``Source/ComputeControllers/ParallelSort.cpp:236-298``).
REFERENCE_PARITY_CONFIG = EngineConfig(radix_bits=1)

