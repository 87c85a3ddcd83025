"""Group-by aggregation over columnar tables (BASELINE.json config 4).

No reference equivalent (the reference only sorts) — but the design is the
reference's own primitives recomposed: stable sort brings equal keys
together, the boundary mask between key runs is "the extracted bit", a
*segmented* prefix combine (resetting at run starts) leaves each group's
aggregate at its run end, and the stable compaction pass collects one row per
group.  Sort + scan + compact, no hash table: a sorted aggregation whose
output is deterministic and key-ordered.  Aggregates are segment-local:
integer sums wrap exactly like the payload dtype (numpy semantics) and float
sums never touch a global accumulator.

``aggregate_sorted_flat`` is the mesh-shardable core (plain arrays, traced
live count) reused by ``parallel.dist_ops`` inside ``shard_map``.

Aggregation kinds: sum, count, min, max, mean.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import jax
import jax.numpy as jnp

from gpuradixsort.config import EngineConfig
from gpuradixsort.core.table import Column, Table
from gpuradixsort.ops.filter import Selection, _compact_by_mask
from gpuradixsort.ops.sort import sort_table

SUPPORTED = ("sum", "count", "min", "max", "mean")


def _neutral_for(kind: str, dtype):
    if kind in ("sum", "mean", "count"):
        return jnp.zeros((), dtype)
    if jnp.issubdtype(dtype, jnp.integer):
        info = jnp.iinfo(dtype)
        return info.max if kind == "min" else info.min
    return jnp.inf if kind == "min" else -jnp.inf


def aggregate_sorted_flat(
    keys: jax.Array,
    n_live,
    inputs: Sequence[tuple[str, jax.Array | None, str]],
    cfg: EngineConfig,
):
    """Aggregate a key-sorted padded array per equal-key run.

    ``keys``: (padded,) uint32 sorted ascending with live rows first;
    ``n_live`` may be a python int or a traced scalar (shard_map-safe).
    ``inputs``: (out_name, value_array_or_None, kind) — None arrays are only
    valid for kind="count".  Returns ``(group_keys, {name: values}, count)``
    — compacted to the front, one row per group, rows >= count are zeros.
    """
    padded = keys.shape[0]
    pos = jnp.arange(padded, dtype=jnp.int32)
    live = pos < n_live

    # Run boundaries in sorted order: first-of-group / last-of-group masks.
    prev = jnp.concatenate([keys[:1] ^ jnp.uint32(1), keys[:-1]])
    is_first = (keys != prev) | (pos == 0)
    nxt = jnp.concatenate([keys[1:], keys[-1:] ^ jnp.uint32(1)])
    is_last = ((keys != nxt) | (pos == padded - 1)) & live

    # Segment-local running aggregates: an associative prefix combine over
    # (value, segment-start) pairs that RESETS at run starts, so the value at
    # a run end is the aggregate of exactly that group — never a difference
    # of global accumulators (which is exact only modulo the dtype for ints
    # and catastrophically lossy for floats at scale).
    def segmented(v, op, neutral):
        vv = jnp.where(live, v, jnp.full_like(v, neutral))

        def combine(a, b):
            av, af = a
            bv, bf = b
            return (jnp.where(bf, bv, op(av, bv)), af | bf)

        seg, _ = jax.lax.associative_scan(combine, (vv, is_first))
        return seg

    running: dict[str, jax.Array] = {}
    need_counts = any(kind == "mean" for _, _, kind in inputs)
    for out_name, v, kind in inputs:
        if kind == "count":
            v = jnp.ones((padded,), jnp.int32)
        if kind == "mean":
            # Mean is a float aggregate: accumulate in float32 so integer
            # payloads don't wrap on the way to the division.
            v = v.astype(jnp.float32)
        op = {"min": jnp.minimum, "max": jnp.maximum}.get(kind, jnp.add)
        running[out_name] = segmented(v, op, _neutral_for(kind, v.dtype))
    if need_counts:
        running["__count"] = segmented(
            jnp.ones((padded,), jnp.int32), jnp.add, jnp.int32(0)
        )

    # Compact run-end rows to the front (one binary counting-sort pass).
    names = list(running.keys())
    values = [keys] + [running[name] for name in names]
    compacted, count = _compact_by_mask(is_last.astype(jnp.int32), values, cfg)
    group_keys = compacted[0]
    comp = dict(zip(names, compacted[1:]))

    valid_group = pos < count
    out: dict[str, jax.Array] = {}
    for out_name, _, kind in inputs:
        c = comp[out_name]
        if kind == "mean":
            # float32 division; integer sums are exact until they exceed the
            # payload dtype (wrap semantics match numpy's).
            c = c / jnp.maximum(comp["__count"], 1).astype(jnp.float32)
        out[out_name] = jnp.where(valid_group, c, jnp.zeros_like(c))
    group_keys = jnp.where(valid_group, group_keys, jnp.zeros_like(group_keys))
    return group_keys, out, count


def group_by_aggregate(
    table: Table,
    key: str,
    aggs: Mapping[str, tuple[str, str]],
    cfg: EngineConfig | None = None,
    method: str = "auto",
) -> Selection:
    """Group ``table`` by uint32 column ``key`` and aggregate.

    ``aggs`` maps output column name -> (input column name, kind) with kind
    one of sum/count/min/max/mean.  Returns a Selection whose table holds one
    row per group (keys ascending), with the group count as device scalar.
    """
    cfg = cfg or EngineConfig()
    for out_name, (col, kind) in aggs.items():
        if kind not in SUPPORTED:
            raise ValueError(f"unsupported aggregation {kind!r} for {out_name}")
        if kind != "count" and col not in table.columns:
            raise KeyError(f"aggregation input column {col!r} not in table")

    ordered = sort_table(table, key, cfg, method)
    inputs = [
        (out_name, None if kind == "count" else ordered[col].data, kind)
        for out_name, (col, kind) in aggs.items()
    ]
    group_keys, out, count = aggregate_sorted_flat(
        ordered[key].data, table.length, inputs, cfg
    )
    n = table.length
    result: dict[str, Column] = {key: Column(group_keys, n)}
    for out_name, vals in out.items():
        result[out_name] = Column(vals, n)
    return Selection(Table(result), count)
