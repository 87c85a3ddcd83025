"""Filter (selection) operator: predicate -> mask -> scan -> stable compact.

No reference equivalent exists (the reference only sorts), but the machinery
is the reference's own scan pipeline repurposed, per the north-star operator
set (BASELINE.json config 3): the predicate mask plays the role of the
extracted bit (``GetBitForPrefixScan.comp:36-41``), the hierarchical
exclusive scan assigns compacted destinations, and the stable scatter places
selected rows first — exactly one binary counting-sort pass on the negated
predicate.

XLA's static-shape constraint means the compacted table keeps its padded
buffer size; the number of selected rows rides along as a device scalar (the
``totalNumberOfOnes`` slot of ``PrefixScanBuffer.comp:34-39``).  Use
``Selection.to_table()`` to sync the count to the host and slice.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp

from gpuradixsort.config import EngineConfig
from gpuradixsort.core.table import Column, Table
from gpuradixsort.kernels import radix as radix_kernels
from gpuradixsort.ops import permute


@dataclasses.dataclass(frozen=True)
class Selection:
    """A filtered table: selected rows first, count as a device scalar."""

    table: Table
    count: jax.Array  # int32 scalar, number of selected rows

    def to_table(self) -> Table:
        """Sync the count to the host and return a tight Table."""
        n = int(self.count)
        return Table(
            {
                name: Column(col.data, min(n, col.length))
                for name, col in self.table.columns.items()
            }
        )


def _compact_by_mask(
    mask: jax.Array, values: list[jax.Array], cfg: EngineConfig
) -> tuple[list[jax.Array], jax.Array]:
    """Stably move rows with mask==1 to the front.

    One binary counting-sort pass on digit (1 - mask): the radix histogram /
    destination primitives see "selected" as digit 0 and "dropped" as digit
    1, so selected rows land first, both groups in original order.
    """
    bit_cfg = EngineConfig(radix_bits=1, tile_rows=cfg.tile_rows)
    digit = (1 - mask).astype(jnp.uint32)
    hist = radix_kernels.tile_histograms(digit, 0, bit_cfg)
    offsets = radix_kernels.global_offsets(hist)
    dest = radix_kernels.tile_destinations(digit, offsets, 0, bit_cfg)
    out = permute.scatter_by_destination(dest, values)
    count = jnp.sum(mask.astype(jnp.int32))
    return out, count


def filter_table(
    table: Table,
    predicate: Callable[[Table], jax.Array],
    cfg: EngineConfig | None = None,
) -> Selection:
    """Keep rows where ``predicate`` is true, preserving order.

    ``predicate`` receives the table and returns a boolean/int mask over the
    padded row space; pad rows are masked out automatically.
    """
    cfg = cfg or EngineConfig()
    mask = predicate(table).astype(jnp.int32)
    n = table.length
    padded = next(iter(table.columns.values())).padded_length
    if mask.shape[0] != padded:
        raise ValueError(
            f"predicate mask has shape {mask.shape}, expected ({padded},)"
        )
    # Pad rows never survive the filter.
    live = (jnp.arange(padded, dtype=jnp.int32) < n).astype(jnp.int32)
    mask = mask * live
    names = table.names()
    values = [table[name].data for name in names]
    out, count = _compact_by_mask(mask, values, cfg)
    out_table = Table(
        {name: Column(data, table[name].length) for name, data in zip(names, out)}
    )
    return Selection(out_table, count)
