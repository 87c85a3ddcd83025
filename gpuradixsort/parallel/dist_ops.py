"""Distributed group-by aggregate and equi-join (BASELINE configs 4-5).

Both ride the range-partition exchange of ``dist_sort``: keys are bucketed by
observed global range (``psum`` histogram), buckets map to shards whole, and
a tiled ``all_to_all`` moves (key, payload) rows so that **equal keys always
colocate** — the distributed-shuffle analog of the reference's two-level
scan hierarchy (SURVEY.md §2c/§5: radix-digit partitioning + all-to-all as
the TP/EP routing analog).  After the exchange every group/join key lives on
exactly one shard, so the local operators (segmented aggregation, sorted run
-expansion join) produce globally correct results; shard outputs concatenate
in key order.

Static-shape discipline: per-shard outputs are fixed-capacity buffers + live
counts, with ``overflow`` flags and host-side capacity retry — the engine's
padded-output pattern (after ``OriginalDataToIntermediateData.comp:44-47``).
"""

from __future__ import annotations

import functools
from typing import Mapping, NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from gpuradixsort.config import PAD_INDEX, PAD_KEY, EngineConfig
from gpuradixsort.core.table import round_up
from gpuradixsort.ops.aggregate import SUPPORTED, aggregate_sorted_flat
from gpuradixsort.ops.filter import _compact_by_mask
from gpuradixsort.ops.sort import resolve_method
from gpuradixsort.parallel.dist_sort import _shard_exchange_sorted
from gpuradixsort.parallel.mesh import ROW_AXIS


class ShardedGroups(NamedTuple):
    """Per-shard aggregated groups: global result = concat of live prefixes."""

    keys: jax.Array  # (num_shards, cap) uint32 group keys, ascending
    values: dict  # name -> (num_shards, cap) aggregated values
    counts: jax.Array  # (num_shards,) int32 groups per shard
    overflow: jax.Array  # () bool — exchange capacity exceeded


class ShardedJoin(NamedTuple):
    """Per-shard expanded join rows: global result = concat, key-ordered."""

    keys: jax.Array  # (num_shards, cap) uint32 matched keys
    probe_values: jax.Array  # (num_shards, cap)
    build_values: jax.Array  # (num_shards, cap)
    counts: jax.Array  # (num_shards,) int32 output rows per shard
    overflow: jax.Array  # () bool — exchange or join capacity exceeded


def _agg_shard_fn(keys, values, n_live, *, specs, cfg, num_shards, capacity,
                  bucket_bits, method):
    mkeys, midx, mvals, count, overflow = _shard_exchange_sorted(
        keys, tuple(values), n_live, cfg, num_shards, capacity, bucket_bits,
        method,
    )
    # Pad repair: pads ride as key 0xFFFFFFFF with PAD_INDEX; compact live
    # rows (stably — key order preserved) so the live prefix is clean.
    compacted, live_count = _compact_by_mask(
        (midx != PAD_INDEX).astype(jnp.int32), [mkeys, *mvals], cfg
    )
    mkeys = compacted[0]
    mvals = compacted[1:]
    inputs = [
        (out_name, None if kind == "count" else mvals[vi], kind)
        for out_name, vi, kind in specs
    ]
    gkeys, out, gcount = aggregate_sorted_flat(mkeys, live_count, inputs, cfg)
    return (
        gkeys,
        tuple(out[name] for name, _, _ in specs),
        gcount.reshape(1),
        overflow,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "cfg", "specs", "num_values", "bucket_bits", "cap_factor",
        "method",
    ),
)
def _dist_agg_padded(keys, values, n_live, mesh, cfg, specs, num_values,
                     bucket_bits, cap_factor, method):
    del num_values  # keys the jit cache on the pytree arity
    num_shards = mesh.shape[ROW_AXIS]
    n_local = keys.shape[0] // num_shards
    capacity = round_up(
        max(1, int(n_local * cap_factor) // num_shards), cfg.block
    )
    fn = functools.partial(
        _agg_shard_fn, specs=specs, cfg=cfg, num_shards=num_shards,
        capacity=capacity, bucket_bits=bucket_bits, method=method,
    )
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS), P(ROW_AXIS), P()),
        out_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P()),
    )(keys, values, n_live)


def dist_group_by_aggregate(
    keys: jax.Array,
    values: Mapping[str, jax.Array],
    aggs: Mapping[str, tuple[str, str]],
    mesh,
    cfg: EngineConfig | None = None,
    bucket_bits: int = 12,
    cap_factor: float = 2.0,
    method: str = "auto",
    n_live: int | None = None,
    auto_retry: bool = True,
) -> ShardedGroups:
    """Distributed group-by aggregation over a device mesh.

    ``keys``: (n,) uint32 (n divisible by num_shards * cfg.block; pad with
    PAD_KEY).  ``values``: named payload arrays; ``aggs`` maps output name ->
    (value name, kind) with kind in sum/count/min/max/mean.  Rows are
    exchanged so each group lands whole on one shard; shard outputs
    concatenate in ascending key order (``gather_groups``).
    """
    cfg = cfg or EngineConfig()
    method = resolve_method(method)
    for out_name, (vname, kind) in aggs.items():
        if kind not in SUPPORTED:
            raise ValueError(f"unsupported aggregation {kind!r} for {out_name}")
        if kind != "count" and vname not in values:
            raise KeyError(f"aggregation input {vname!r} not in values")
    num_shards = mesh.shape[ROW_AXIS]
    n = keys.shape[0]
    if n % (num_shards * cfg.block):
        raise ValueError(
            f"n={n} must be a multiple of num_shards*block="
            f"{num_shards * cfg.block}; pad first"
        )
    if n_live is None:
        n_live = n
    vnames = list(values.keys())
    varrs = tuple(values[v] for v in vnames)
    # (out_name, value array position, kind) — static across the shard body.
    specs = tuple(
        (out_name, vnames.index(vname) if kind != "count" else 0, kind)
        for out_name, (vname, kind) in aggs.items()
    )
    n_local = n // num_shards
    while True:
        gkeys, gvals, counts, overflow = _dist_agg_padded(
            keys, varrs, jnp.uint32(n_live), mesh, cfg, specs, len(varrs),
            bucket_bits, cap_factor, method,
        )
        capacity_full = round_up(
            max(1, int(n_local * cap_factor) // num_shards), cfg.block
        ) >= n_local
        if not auto_retry or not bool(overflow) or capacity_full:
            break
        cap_factor *= 2.0
    num = num_shards
    vals = {
        name: arr.reshape(num, -1)
        for (name, _, _), arr in zip(specs, gvals)
    }
    return ShardedGroups(
        gkeys.reshape(num, -1), vals, counts.reshape(num), overflow
    )


def gather_groups(result: ShardedGroups):
    """Host-side assembly: concatenate live prefixes in shard order."""
    import numpy as np

    if bool(result.overflow):
        raise RuntimeError(
            "distributed aggregate overflowed shard capacity; retry with "
            "larger cap_factor or more bucket_bits"
        )
    counts = np.asarray(result.counts)
    keys = np.asarray(result.keys)
    out_k = np.concatenate([keys[s, : counts[s]] for s in range(len(counts))])
    out_v = {
        name: np.concatenate(
            [np.asarray(arr)[s, : counts[s]] for s in range(len(counts))]
        )
        for name, arr in result.values.items()
    }
    return out_k, out_v


def _join_shard_fn(keys, side, live, payload, *, cfg, num_shards, capacity,
                   join_cap, bucket_bits, method):
    n_local = keys.shape[0]
    mkeys, midx, (mside, mlive, mpay), count, overflow = (
        _shard_exchange_sorted(
            keys, (side, live, payload), jnp.uint32(2**32 - 1), cfg,
            num_shards, capacity, bucket_bits, method,
        )
    )
    del midx, count
    # Split the key-sorted mixed rows back into probe / build (stable
    # compactions keep each side key-sorted).
    (pk, pv), count_p = _compact_by_mask(
        ((mside == 0) & (mlive == 1)).astype(jnp.int32), [mkeys, mpay], cfg
    )
    (bk, bv), count_b = _compact_by_mask(
        ((mside == 1) & (mlive == 1)).astype(jnp.int32), [mkeys, mpay], cfg
    )
    total_rows = pk.shape[0]
    pos = jnp.arange(total_rows, dtype=jnp.int32)
    # Tails past the live counts are compaction leftovers; force them to the
    # sentinel so searchsorted sees clean sorted arrays.
    pk = jnp.where(pos < count_p, pk, PAD_KEY)
    bk = jnp.where(pos < count_b, bk, PAD_KEY)

    lo = jnp.minimum(
        jnp.searchsorted(bk, pk, side="left").astype(jnp.int32), count_b
    )
    hi = jnp.minimum(
        jnp.searchsorted(bk, pk, side="right").astype(jnp.int32), count_b
    )
    cnt = jnp.where(pos < count_p, hi - lo, 0)
    offsets = jnp.cumsum(cnt) - cnt
    total = jnp.sum(cnt)
    # Replicate the combined flag (join capacity is judged per shard).
    overflow = (
        jax.lax.pmax(
            (overflow | (total > join_cap)).astype(jnp.int32), ROW_AXIS
        )
        > 0
    )

    slots = jnp.arange(join_cap, dtype=jnp.int32)
    prow = (
        jnp.searchsorted(offsets + cnt, slots, side="right")
        .astype(jnp.int32)
        .clip(0, total_rows - 1)
    )
    ordinal = slots - jnp.take(offsets, prow, mode="clip")
    brow = jnp.clip(jnp.take(lo, prow, mode="clip") + ordinal, 0,
                    total_rows - 1)
    valid = slots < jnp.minimum(total, join_cap)
    out_k = jnp.where(valid, jnp.take(pk, prow, mode="clip"), PAD_KEY)
    out_pv = jnp.where(
        valid, jnp.take(pv, prow, mode="clip"), jnp.zeros((), pv.dtype)
    )
    out_bv = jnp.where(
        valid, jnp.take(bv, brow, mode="clip"), jnp.zeros((), bv.dtype)
    )
    return out_k, out_pv, out_bv, jnp.minimum(total, join_cap).reshape(1), (
        overflow
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "mesh", "cfg", "bucket_bits", "cap_factor", "join_cap_factor",
        "method", "n_probe", "n_build",
    ),
)
def _dist_join_padded(pk, pv, bk, bv, mesh, cfg, bucket_bits, cap_factor,
                      join_cap_factor, method, n_probe, n_build):
    num_shards = mesh.shape[ROW_AXIS]
    n_p = pk.shape[0]
    n_b = bk.shape[0]
    # Interleave both sides into one exchange so they share one bucket map:
    # same key -> same shard for probe AND build rows.
    keys = jnp.concatenate([pk, bk])
    side = jnp.concatenate(
        [jnp.zeros((n_p,), jnp.uint32), jnp.ones((n_b,), jnp.uint32)]
    )
    live = jnp.concatenate(
        [
            (jnp.arange(n_p, dtype=jnp.int32) < n_probe).astype(jnp.uint32),
            (jnp.arange(n_b, dtype=jnp.int32) < n_build).astype(jnp.uint32),
        ]
    )
    payload = jnp.concatenate([pv, bv])
    # Shard-major reshuffle: shard s must hold slice s of both sides.
    def to_shard_major(x_p, x_b):
        a = x_p.reshape(num_shards, -1)
        b = x_b.reshape(num_shards, -1)
        return jnp.concatenate([a, b], axis=1).reshape(-1)

    keys = to_shard_major(keys[:n_p], keys[n_p:])
    side = to_shard_major(side[:n_p], side[n_p:])
    live = to_shard_major(live[:n_p], live[n_p:])
    payload = to_shard_major(payload[:n_p], payload[n_p:])

    n_local = (n_p + n_b) // num_shards
    capacity = round_up(
        max(1, int(n_local * cap_factor) // num_shards), cfg.block
    )
    join_cap = round_up(max(1, int(n_local * join_cap_factor)), cfg.block)
    fn = functools.partial(
        _join_shard_fn, cfg=cfg, num_shards=num_shards, capacity=capacity,
        join_cap=join_cap, bucket_bits=bucket_bits, method=method,
    )
    return jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS),) * 4,
        out_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P()),
    )(keys, side, live, payload)


def dist_join_inner(
    probe_keys: jax.Array,
    probe_values: jax.Array,
    build_keys: jax.Array,
    build_values: jax.Array,
    mesh,
    cfg: EngineConfig | None = None,
    bucket_bits: int = 12,
    cap_factor: float = 2.0,
    join_cap_factor: float = 2.0,
    method: str = "auto",
    n_probe: int | None = None,
    n_build: int | None = None,
    auto_retry: bool = True,
) -> ShardedJoin:
    """Distributed inner equi-join with duplicate-key run expansion.

    Both sides are interleaved into ONE range-partition exchange (a shared
    bucket map guarantees equal keys from both sides colocate), then each
    shard run-expands its sorted probe rows against its sorted build rows.
    Output rows are key-ordered across shards; sizes are static capacities
    with live counts and an overflow flag (auto-retried with doubled slack).
    Payload arrays must share one dtype per side argument.
    """
    cfg = cfg or EngineConfig()
    method = resolve_method(method)
    num_shards = mesh.shape[ROW_AXIS]
    for name, arr in (("probe", probe_keys), ("build", build_keys)):
        if arr.shape[0] % (num_shards * cfg.block):
            raise ValueError(
                f"{name} length {arr.shape[0]} must be a multiple of "
                f"num_shards*block={num_shards * cfg.block}; pad first"
            )
    if n_probe is None:
        n_probe = probe_keys.shape[0]
    if n_build is None:
        n_build = build_keys.shape[0]
    while True:
        k, pv, bv, counts, overflow = _dist_join_padded(
            probe_keys, probe_values, build_keys, build_values, mesh, cfg,
            bucket_bits, cap_factor, join_cap_factor, method, n_probe,
            n_build,
        )
        if not auto_retry or not bool(overflow) or join_cap_factor >= 64:
            break
        cap_factor *= 2.0
        join_cap_factor *= 2.0
    num = num_shards
    return ShardedJoin(
        k.reshape(num, -1), pv.reshape(num, -1), bv.reshape(num, -1),
        counts.reshape(num), overflow,
    )


def gather_join(result: ShardedJoin):
    """Host-side assembly: concatenate live prefixes in shard order."""
    import numpy as np

    if bool(result.overflow):
        raise RuntimeError(
            "distributed join overflowed capacity; retry with larger "
            "cap_factor/join_cap_factor"
        )
    counts = np.asarray(result.counts)
    take = lambda a: np.concatenate(  # noqa: E731
        [np.asarray(a)[s, : counts[s]] for s in range(len(counts))]
    )
    return take(result.keys), take(result.probe_values), take(
        result.build_values
    )
