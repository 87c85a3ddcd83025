"""Stable LSD radix sort over columnar buffers — the ParallelSort controller.

Reference equivalent: ``Source/ComputeControllers/ParallelSort.cpp::Sort()``
(``:168-323``) — 32 passes x 4 dispatches of 1-bit extract / group scan /
group-sums scan / stable scatter over a ping-pong half-buffer, then a payload
gather.  Here the ``"radix"`` method runs ``key_bits / radix_bits`` passes (8
by default), each pass = one per-tile histogram + one tiny offsets
computation + one destination computation + one unique-index scatter;
ping-pong buffering is implicit in XLA's functional arrays (the reference
needed an explicit half/half SSBO, ``Include/SSBOs/IntermediateDataSsbo.h:
7-10``, because GLSL mutates in place).  The ``"xla"`` method hands the
whole sort to ``lax.sort``; ``"auto"`` chooses between them
(``resolve_method``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from gpuradixsort.config import PAD_INDEX, PAD_KEY, EngineConfig
from gpuradixsort.core.table import Column, Table, pad_to_tile
from gpuradixsort.kernels import radix as radix_kernels
from gpuradixsort.ops import permute


def _radix_pass(
    keys: jax.Array, carried: tuple, shift: int, cfg: EngineConfig
) -> tuple:
    """One stable counting-sort pass on digit (keys >> shift) & (radix-1).

    keys: (padded_n,) uint32.  carried: extra arrays permuted alongside.
    Returns (keys, carried) reordered by the digit, stably.
    """
    hist = radix_kernels.tile_histograms(keys, shift, cfg)
    offsets = radix_kernels.global_offsets(hist)
    dest = radix_kernels.tile_destinations(keys, offsets, shift, cfg)
    out = permute.scatter_by_destination(dest, [keys, *carried])
    return out[0], tuple(out[1:])


@functools.partial(jax.jit, static_argnames=("cfg", "num_carried"))
def _sort_padded(keys: jax.Array, carried: tuple, cfg: EngineConfig,
                 num_carried: int):
    del num_carried  # only used to key the jit cache on the pytree arity
    for p in range(cfg.num_passes):
        keys, carried = _radix_pass(keys, carried, p * cfg.radix_bits, cfg)
    return keys, carried


def _xla_sort_padded(keys: jax.Array, carried: tuple):
    """Whole sort via ``lax.sort`` (stable).

    XLA lowers a one- or two-operand sort on uint32 keys to a CUB device
    radix sort on the GPU.
    """
    out = jax.lax.sort((keys, *carried), num_keys=1, is_stable=True)
    return out[0], tuple(out[1:])


# "radix": the engine's own LSD pipeline, ``cfg.num_passes`` passes of
# histogram -> offsets -> destinations -> scatter; the semantic reference,
# and the only path whose digit width ``cfg`` sets.  "xla": ``lax.sort``.
METHODS = ("radix", "xla")


def resolve_method(method: str) -> str:
    """Map a user ``method`` to the sort that runs; ``"auto"`` -> ``"xla"``.

    One rule on every backend, so the CPU tests run what the GPU runs.  On
    one H100 ``xla`` beat ``radix`` at both 1,048,576 and 100M keys (the
    measurement is recorded in CHANGES.md), so ``auto`` never picks
    ``radix``.
    """
    if method == "auto":
        return "xla"
    if method not in METHODS:
        raise ValueError(
            f"unknown sort method {method!r}; expected 'auto' or one of "
            f"{METHODS}"
        )
    return method


def _sort_column(col: Column, carried: tuple, cfg: EngineConfig,
                 method: str):
    if resolve_method(method) == "radix":
        return _sort_padded(col.data, carried, cfg, len(carried))
    return _xla_sort_padded(col.data, carried)


def sort_keys(
    keys: Column | jax.Array,
    cfg: EngineConfig | None = None,
    method: str = "auto",
) -> Column:
    """Sort a uint32 key column ascending, stably.  Returns a new Column."""
    cfg = cfg or EngineConfig()
    col = _as_key_column(keys, cfg)
    sorted_keys, _ = _sort_column(col, (), cfg, method)
    return Column(sorted_keys, col.length)


def sort_pairs(
    keys: Column | jax.Array,
    cfg: EngineConfig | None = None,
    method: str = "auto",
) -> tuple[Column, Column]:
    """Sort (key, original-row-index) pairs — the IntermediateData pipeline.

    The index column is the ``_globalIndexOfOriginalData`` of
    ``Include/SSBOs/IntermediateData.h:13-28``: it starts as iota and ends as
    the permutation that sorts the keys; pad entries carry PAD_INDEX.
    Stability of the radix passes guarantees equal keys keep original order,
    and that live rows precede pad rows even when live keys equal PAD_KEY.
    """
    cfg = cfg or EngineConfig()
    col = _as_key_column(keys, cfg)
    # The index column spans the key column's whole buffer, which after a
    # filter can be longer than the live rows rounded up to a block.
    pos = jnp.arange(col.padded_length, dtype=jnp.uint32)
    idx = jnp.where(pos < col.length, pos, PAD_INDEX)
    sorted_keys, (perm,) = _sort_column(col, (idx,), cfg, method)
    return Column(sorted_keys, col.length), Column(perm, col.length)


def sort_table(
    table: Table,
    key: str,
    cfg: EngineConfig | None = None,
    method: str = "auto",
) -> Table:
    """Sort a whole table by one uint32 key column, stably.

    Key+payload sort: sort (key, index) pairs, then gather every payload
    column through the sorted index — the ``SortOriginalData.comp:33-50``
    payload permutation, generalized to arbitrarily many columns.
    """
    cfg = cfg or EngineConfig()
    key_col = table[key]
    sorted_keys, perm = sort_pairs(key_col, cfg, method)
    out = {key: sorted_keys}
    src = perm.data.astype(jnp.int32)
    for name in table.names():
        if name == key:
            continue
        col = table[name]
        # Pad rows gather arbitrary data (their src is the PAD_INDEX
        # sentinel, clipped); they sit past `length` and are never observed.
        gathered = permute.gather_rows(
            col.data, jnp.clip(src, 0, col.padded_length - 1)
        )
        out[name] = Column(gathered, col.length)
    return Table(out)


def _as_key_column(keys, cfg: EngineConfig | None) -> Column:
    cfg = cfg or EngineConfig()
    if isinstance(keys, Column):
        # Rows past the live prefix may hold arbitrary data (e.g. the dropped
        # rows after a filter compaction) — re-assert the pad sentinel so
        # they sort to the back, exactly like the reference's pad writes in
        # OriginalDataToIntermediateData.comp:44-47.
        if keys.length == keys.padded_length:
            return keys
        pos = jnp.arange(keys.padded_length, dtype=jnp.int32)
        data = jnp.where(pos < keys.length, keys.data, PAD_KEY)
        return Column(data, keys.length)
    arr = jnp.asarray(keys, dtype=jnp.uint32)
    return Column(pad_to_tile(arr, cfg, PAD_KEY), arr.shape[0])
