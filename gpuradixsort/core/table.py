"""Columnar device-resident buffers — the SSBO layer.

The reference wraps raw GL buffers in thin RAII classes (``SsboBase`` and
friends, ``Include/SSBOs/SsboBase.h:12-46``) holding a device allocation plus
its logical element count, with padding arithmetic owned by ``PrefixSumSsbo``
(round N up to a multiple of ITEMS_PER_WORK_GROUP; ``Source/SSBOs/
PrefixSumSsbo.cpp:102-104``).  The equivalent here is an Arrow-style columnar
table: each column is one device array padded to a tile multiple, with the
live row count tracked host-side (XLA requires static shapes, so "length" is
metadata, exactly like the reference's pad-with-0xffffffff scheme).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np

from gpuradixsort.config import PAD_KEY, EngineConfig


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= n (and >= multiple)."""
    return max(((n + multiple - 1) // multiple) * multiple, multiple)


def pad_to_tile(arr: jax.Array, cfg: EngineConfig, fill) -> jax.Array:
    """Pad a 1-D array's tail up to a tile multiple with ``fill``.

    Mirror of the reference's tail padding: threads past the live count write
    pad pairs with key 0xffffffff so padding sorts to the back
    (``OriginalDataToIntermediateData.comp:36-51``).  Here the pad happens once
    at column construction instead of inside every kernel.
    """
    n = arr.shape[0]
    padded = round_up(n, cfg.block)
    if padded == n:
        return arr
    fill_arr = jnp.full((padded - n,) + arr.shape[1:], fill, dtype=arr.dtype)
    return jnp.concatenate([arr, fill_arr], axis=0)


@dataclasses.dataclass(frozen=True)
class Column:
    """One device-resident column: padded data + live row count.

    ``data`` has static shape (padded_length, ...); rows >= ``length`` are pad
    rows.  The equivalent of one SSBO plus its ``NumItems()``
    (``Include/SSBOs/SsboBase.h:35-41``).
    """

    data: jax.Array
    length: int

    def __post_init__(self):
        if self.length > self.data.shape[0]:
            raise ValueError(
                f"length {self.length} exceeds buffer size {self.data.shape[0]}"
            )

    @property
    def padded_length(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    def valid(self) -> jax.Array:
        """The live (unpadded) prefix, materialized."""
        return self.data[: self.length]

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.valid())


def make_column(
    values, cfg: EngineConfig | None = None, fill=0, dtype=None
) -> Column:
    """Build a tile-padded Column from host or device values."""
    cfg = cfg or EngineConfig()
    arr = jnp.asarray(values, dtype=dtype)
    n = arr.shape[0]
    return Column(data=pad_to_tile(arr, cfg, fill), length=n)


def make_key_column(values, cfg: EngineConfig | None = None) -> Column:
    """A uint32 sort-key column, padded with PAD_KEY so pads sort last."""
    cfg = cfg or EngineConfig()
    arr = jnp.asarray(values, dtype=jnp.uint32)
    return Column(data=pad_to_tile(arr, cfg, PAD_KEY), length=arr.shape[0])


@dataclasses.dataclass(frozen=True)
class Table:
    """A named collection of equal-length columns (the "whatever" payload).

    The reference sorts opaque records by an embedded key ("the framework
    exists for sorting whatever", ``Include/SSBOs/OriginalData.h:5-8``); a
    Table is the columnar generalization: any number of payload columns ride
    along with the key column through sort/filter/join.
    """

    columns: Mapping[str, Column]

    def __post_init__(self):
        lengths = {c.length for c in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged table: column lengths {lengths}")

    @property
    def length(self) -> int:
        return next(iter(self.columns.values())).length if self.columns else 0

    def __getitem__(self, name: str) -> Column:
        return self.columns[name]

    def names(self):
        return list(self.columns.keys())

    def with_column(self, name: str, col: Column) -> "Table":
        cols = dict(self.columns)
        cols[name] = col
        return Table(cols)


def table_from_arrays(cfg: EngineConfig | None = None, **arrays) -> Table:
    cfg = cfg or EngineConfig()
    return Table({k: make_column(v, cfg) for k, v in arrays.items()})
