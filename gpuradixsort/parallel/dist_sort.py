"""Distributed stable sort: range-partition exchange + local radix sort.

The reference's two-level scan (work-group scan + scan-of-group-sums,
``ParallelPrefixScan.comp:93-104,151-196``) is the in-miniature pattern this
module scales to a device mesh (SURVEY.md §5 "long-context analog"): the
levels become device-local sort -> global bucket histogram (``psum``) ->
balanced bucket-to-shard assignment -> ``all_to_all`` exchange ->
device-local merge of received runs.

Stability and bit-exactness:
- Buckets are key-prefix ranges, so equal keys always land on one shard.
- The all_to_all receive buffer is source-major and each source block is
  locally sorted, so a stable local sort reproduces global original order
  among equal keys — except pad sentinels interleaving with real
  0xFFFFFFFF keys, which a final stable binary partition on the pad-index
  sentinel repairs.
- Output is a ragged sharded table: per-shard sorted buffers of static
  capacity plus live counts (XLA static shapes; the reference's
  pad-with-0xffffffff trick, ``OriginalDataToIntermediateData.comp:44-47``,
  applied at the shard level).

Skew handling: bucket->shard assignment balances *observed* global bucket
counts (midpoint rule), so moderate skew re-partitions automatically; a
single bucket larger than a shard's capacity sets the ``overflow`` flag —
callers retry with a larger ``cap_factor`` or more ``bucket_bits``.

On exchange/compute overlap (SURVEY.md §7 hard part 5): two exchange
schedules are provided.  The default is one monolithic ``all_to_all`` + a
P-way merge tree; XLA's async collective scheduling overlaps the
independent keys/index/extras exchanges with each other and with the pack
compute.  ``overlap=True`` selects the ring schedule
(:func:`_ring_merge_exchange`): P-1 single-step ``ppermute`` rounds, each
round's incoming block folded into a fixed-size accumulator while the next
round's permute — whose operand depends only on the pre-packed send blocks,
never on the previous merge — is free to fly concurrently.  Chunk-major
merging is stable despite the cyclic (non-rank-monotone) arrival order
because each fold merges on the composite (key, global-original-index) with
``lax.sort(num_keys=2)``: the index column that already rides the exchange
IS the total stability order (gidx = shard * n_local + i), so arrival order
cannot perturb ties, and pad sentinels (max key, max index) sort strictly
last, which makes the fixed-capacity accumulator truncation exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from gpuradixsort.config import PAD_INDEX, PAD_KEY, EngineConfig
from gpuradixsort.core.table import round_up
from gpuradixsort.ops.filter import _compact_by_mask
from gpuradixsort.ops.sort import _sort_padded, resolve_method
from gpuradixsort.parallel.mesh import ROW_AXIS


class ShardedSort(NamedTuple):
    """Per-shard sorted runs: global result = concat of live prefixes."""

    keys: jax.Array  # (num_shards, capacity) uint32, sorted per shard
    index: jax.Array  # (num_shards, capacity) uint32 original row ids
    counts: jax.Array  # (num_shards,) int32 live rows per shard
    overflow: jax.Array  # () bool — capacity exceeded, retry with more slack


def _merge_pair(ak, bk, a_payloads, b_payloads):
    """Stably merge two sorted key runs (+ payloads); a precedes b on ties.

    Classic searchsorted merge: a[i] lands at i + #{b < a[i]} and b[j] at
    j + #{a <= b[j]} — disjoint positions covering 0..2L-1, so two unique
    scatters realize the merge in O(n log n) compares instead of a full
    O(n log^2 n) re-sort of the concatenation.
    """
    length = ak.shape[0]
    pos_a = jnp.arange(length, dtype=jnp.int32) + jnp.searchsorted(
        bk, ak, side="left"
    ).astype(jnp.int32)
    pos_b = jnp.arange(length, dtype=jnp.int32) + jnp.searchsorted(
        ak, bk, side="right"
    ).astype(jnp.int32)

    def place(a, b):
        out = jnp.zeros((2 * length,), a.dtype)
        return out.at[pos_a].set(a, unique_indices=True).at[pos_b].set(
            b, unique_indices=True)

    return place(ak, bk), tuple(
        place(a, b) for a, b in zip(a_payloads, b_payloads)
    )


def _merge_runs(keys2d, payloads2d: tuple):
    """Merge P sorted equal-length runs ((P, L) -> flat) in log2(P) levels.

    The reference's scan-of-group-sums combines per-group partials in one
    extra level (``ParallelPrefixScan.comp:151-196``); this is the sort-side
    analog: received per-source runs are already sorted, so only the merge
    tree remains.  Pad tails (key 0xFFFFFFFF) may interleave with real
    max-keys of later sources; the caller's pad compaction repairs that.
    """
    p = keys2d.shape[0]
    if p & (p - 1):
        raise ValueError(f"merge tree needs power-of-two runs, got {p}")
    while p > 1:
        k_pairs = keys2d.reshape(p // 2, 2, -1)
        p_pairs = tuple(x.reshape(p // 2, 2, -1) for x in payloads2d)
        keys2d, payloads2d = jax.vmap(
            lambda kp, *pp: _merge_pair(
                kp[0], kp[1], tuple(x[0] for x in pp), tuple(x[1] for x in pp)
            )
        )(k_pairs, *p_pairs)
        p //= 2
    return keys2d.reshape(-1), tuple(x.reshape(-1) for x in payloads2d)


def _ring_merge_exchange(
    send_keys: jax.Array,
    send_payloads: tuple,
    send_counts: jax.Array,
    num_shards: int,
    capacity: int,
):
    """Overlapped exchange: P-1 ppermute rounds, merge-as-you-receive.

    ``send_keys``/``send_payloads[0]`` (the global-index column) /
    further payloads: (num_shards, capacity) blocks, row d = my rows for
    dest shard d, each block a slice of my sorted run.  Round s delivers to
    every shard the block from source (me + s) % P in one uniform ppermute;
    the accumulator fold is a stable two-key sort on (key, gidx), so the
    cyclic arrival order is immaterial (see module docstring).  The round
    s+1 permute reads only the static send blocks — never round s's merge —
    so the collective and the fold overlap under XLA's async scheduler.

    Accumulator truncation: live rows after round s are <= (s+1) * capacity
    and pads sort strictly last on (key, gidx), so slicing the
    ((P+1) * capacity)-row fold result back to P * capacity rows only ever
    drops pads.
    """
    me = jax.lax.axis_index(ROW_AXIS)
    total = num_shards * capacity
    acc_k = jnp.full((total,), PAD_KEY, send_keys.dtype)
    acc_p = tuple(
        jnp.full((total,), PAD_INDEX, p.dtype) if i == 0
        else jnp.zeros((total,), p.dtype)
        for i, p in enumerate(send_payloads)
    )
    count = jnp.int32(0)

    def fold(acc_k, acc_p, inc_k, inc_p):
        cat_k = jnp.concatenate([acc_k, inc_k])
        cat_p = tuple(
            jnp.concatenate([a, b]) for a, b in zip(acc_p, inc_p)
        )
        out = jax.lax.sort((cat_k, *cat_p), num_keys=2, is_stable=False)
        return out[0][:total], tuple(x[:total] for x in out[1:])

    for s in range(num_shards):
        # My block destined for shard (me - s) mod P goes out this round...
        pick = jax.lax.rem(
            me - jnp.int32(s) + jnp.int32(num_shards), jnp.int32(num_shards)
        )
        blk_k = jax.lax.dynamic_index_in_dim(
            send_keys, pick, axis=0, keepdims=False
        )
        blk_p = tuple(
            jax.lax.dynamic_index_in_dim(p, pick, axis=0, keepdims=False)
            for p in send_payloads
        )
        blk_c = jax.lax.dynamic_index_in_dim(
            send_counts, pick, axis=0, keepdims=False
        )
        if s:
            # ...so shard me receives the block from source (me + s) mod P.
            perm = [(j, (j - s) % num_shards) for j in range(num_shards)]
            blk_k = jax.lax.ppermute(blk_k, ROW_AXIS, perm)
            blk_p = tuple(
                jax.lax.ppermute(x, ROW_AXIS, perm) for x in blk_p
            )
            blk_c = jax.lax.ppermute(blk_c, ROW_AXIS, perm)
        acc_k, acc_p = fold(acc_k, acc_p, blk_k, blk_p)
        count = count + blk_c
    return acc_k, acc_p, count


def _shard_exchange_sorted(
    keys: jax.Array,
    extras: tuple,
    n_live: jax.Array,
    cfg: EngineConfig,
    num_shards: int,
    capacity: int,
    bucket_bits: int,
    method: str,
    overlap: bool = False,
):
    """Per-shard exchange core (runs under shard_map over the "x" axis).

    Locally sort (key, global-index, *extras), range-partition by observed
    key range, ``all_to_all``-exchange, and merge the received runs.  Returns
    ``(mkeys, midx, merged_extras, count, overflow)`` — per-shard key-sorted
    rows with live count; pad sentinels may interleave with real 0xFFFFFFFF
    keys (callers repair via the PAD_INDEX compaction).
    """
    n_local = keys.shape[0]
    shard = jax.lax.axis_index(ROW_AXIS)
    gidx = (
        shard.astype(jnp.uint32) * jnp.uint32(n_local)
        + jnp.arange(n_local, dtype=jnp.uint32)
    )
    # Tail-pad rows (global index >= n_live) are dropped from the exchange:
    # they would otherwise concentrate in the 0xFFFFFFFF bucket and blow the
    # capacity of the last shard.  After the local sort they form an exact
    # suffix (pads have the max key AND the largest indices, so stability
    # puts them after any real 0xFFFFFFFF keys).
    pad_count = jnp.sum((gidx >= n_live).astype(jnp.int32))
    live_local = jnp.int32(n_local) - pad_count

    # 1. Device-local stable sort of (key, original-global-index, extras).
    if method == "radix":
        skeys, (sidx, *sextras) = _sort_padded(
            keys, (gidx, *extras), cfg, 1 + len(extras)
        )
    else:
        skeys, sidx, *sextras = jax.lax.sort(
            (keys, gidx, *extras), num_keys=1, is_stable=True
        )

    # 2. Global bucket histogram, range-adaptive: buckets split the observed
    #    global [kmin, kmax] live-key range evenly, not the raw uint32 space
    #    (fixed high-bit prefixes collapse e.g. the reference's 0..N-1
    #    permutation dataset into a single bucket).  The bucket map is
    #    monotone in the key, so the locally sorted run stays bucket-sorted
    #    and equal keys share a bucket.
    num_buckets = 1 << bucket_bits
    last = jnp.maximum(live_local - 1, 0)
    kmin_local = jnp.where(live_local > 0, skeys[0], PAD_KEY)
    kmax_local = jnp.where(live_local > 0, skeys[last], jnp.uint32(0))
    kmin = jax.lax.pmin(kmin_local, ROW_AXIS)
    kmax = jax.lax.pmax(kmax_local, ROW_AXIS)
    span = kmax - jnp.minimum(kmin, kmax)
    width = span // jnp.uint32(num_buckets) + jnp.uint32(1)
    # Live keys are all >= kmin and pads are 0xFFFFFFFF >= kmin, so the
    # subtraction never wraps.  Clamp in uint32 BEFORE the int32 cast: with a
    # narrow key range the pad keys' bucket id exceeds int32 and would wrap
    # negative, silently landing pads (and the last shard's rows) in bucket 0.
    sbuckets = jnp.minimum(
        (skeys - kmin) // width, jnp.uint32(num_buckets - 1)
    ).astype(jnp.int32)
    edges = jnp.arange(num_buckets + 1, dtype=jnp.int32)
    bounds = jnp.searchsorted(sbuckets, edges, side="left").astype(jnp.int32)
    local_hist = bounds[1:] - bounds[:-1]
    # Remove the pad suffix from the last bucket's count (pads clip to it).
    local_hist = local_hist.at[num_buckets - 1].add(-pad_count)
    hist = jax.lax.psum(local_hist, ROW_AXIS)  # (num_buckets,)

    # 3. Balanced bucket -> shard assignment (midpoint rule keeps each
    #    bucket whole, so equal keys stay together).
    total = jnp.maximum(jnp.sum(hist), 1)
    cum_excl = jnp.cumsum(hist) - hist
    mid = cum_excl + hist // 2
    shard_of_bucket = jnp.clip(
        (mid * num_shards) // total, 0, num_shards - 1
    ).astype(jnp.int32)

    # 4. Split my sorted run at shard boundaries: first bucket of each shard.
    first_bucket = jnp.searchsorted(
        shard_of_bucket, jnp.arange(num_shards, dtype=jnp.int32), side="left"
    ).astype(jnp.int32)
    lo = jnp.searchsorted(sbuckets, first_bucket, side="left").astype(jnp.int32)
    hi = jnp.concatenate([lo[1:], jnp.asarray([n_local], jnp.int32)])
    # Clip away the pad suffix so pads are never sent anywhere.
    lo = jnp.minimum(lo, live_local)
    hi = jnp.minimum(hi, live_local)
    send_counts = hi - lo  # (num_shards,)
    overflow = jnp.any(send_counts > capacity)

    # 5. Pack fixed-capacity send blocks (gather with tail masking).
    col = jnp.arange(capacity, dtype=jnp.int32)
    src = jnp.clip(lo[:, None] + col[None, :], 0, n_local - 1)
    valid = col[None, :] < send_counts[:, None]

    def pack(arr, fill):
        return jnp.where(valid, jnp.take(arr, src), fill)

    send_keys = pack(skeys, PAD_KEY)
    send_idx = pack(sidx, PAD_INDEX)
    send_extras = tuple(pack(x, jnp.zeros((), x.dtype)) for x in sextras)

    overflow_g = jax.lax.pmax(overflow.astype(jnp.int32), ROW_AXIS) > 0

    # 6'. Overlapped schedule: ring ppermute + merge-as-you-receive.
    if overlap:
        mkeys, (midx, *mextras), count = _ring_merge_exchange(
            send_keys, (send_idx, *send_extras), send_counts,
            num_shards, capacity,
        )
        return mkeys, midx, tuple(mextras), count, overflow_g

    # 6. Exchange.  tiled all_to_all keeps source-major order.
    def exchange(x):
        return jax.lax.all_to_all(
            x, ROW_AXIS, split_axis=0, concat_axis=0, tiled=True
        )

    recv_keys = exchange(send_keys)
    recv_idx = exchange(send_idx)
    recv_extras = tuple(exchange(x) for x in send_extras)
    recv_counts = exchange(send_counts)
    count = jnp.sum(recv_counts).astype(jnp.int32)
    overflow = overflow_g

    # 7. Local stable P-way merge of the received runs: each source block is
    #    a slice of a sorted run, and blocks arrive source-major, so a merge
    #    tree (not a re-sort) combines them.  Non-power-of-two meshes fall
    #    back to the re-sort.
    if num_shards & (num_shards - 1) == 0:
        mkeys, (midx, *mextras) = _merge_runs(
            recv_keys.reshape(num_shards, capacity),
            tuple(
                x.reshape(num_shards, capacity)
                for x in (recv_idx, *recv_extras)
            ),
        )
    else:
        flat = tuple(x.reshape(-1) for x in (recv_idx, *recv_extras))
        if method == "radix":
            mkeys, (midx, *mextras) = _sort_padded(
                recv_keys.reshape(-1), flat, cfg, len(flat)
            )
        else:
            mkeys, midx, *mextras = jax.lax.sort(
                (recv_keys.reshape(-1), *flat), num_keys=1, is_stable=True
            )
    return mkeys, midx, tuple(mextras), count, overflow


def _shard_fn(
    keys: jax.Array,
    n_live: jax.Array,
    cfg: EngineConfig,
    num_shards: int,
    capacity: int,
    bucket_bits: int,
    method: str,
    overlap: bool = False,
):
    """Per-shard distributed-sort body: exchange + pad repair."""
    mkeys, midx, _, count, overflow = _shard_exchange_sorted(
        keys, (), n_live, cfg, num_shards, capacity, bucket_bits, method,
        overlap,
    )
    # Repair the 0xFFFFFFFF tail: real max-keys before pad sentinels.
    (mkeys, midx), _ = _compact_by_mask(
        (midx != PAD_INDEX).astype(jnp.int32), [mkeys, midx], cfg
    )
    return mkeys, midx, count.reshape(1), overflow


@functools.partial(
    jax.jit,
    static_argnames=(
        "cfg", "mesh", "bucket_bits", "cap_factor", "method", "overlap"
    ),
)
def _dist_sort_padded(
    keys: jax.Array,
    n_live: jax.Array,
    mesh,
    cfg: EngineConfig,
    bucket_bits: int,
    cap_factor: float,
    method: str,
    overlap: bool = False,
):
    num_shards = mesh.shape[ROW_AXIS]
    n = keys.shape[0]
    n_local = n // num_shards
    # Capacity of one (source -> dest) exchange block.  Balanced data sends
    # ~n_local/num_shards per block; cap_factor is the skew slack.  Each
    # shard's receive buffer is num_shards * capacity ~ cap_factor * n_local,
    # so per-shard memory stays O(N / num_shards).
    capacity = round_up(
        max(1, int(n_local * cap_factor) // num_shards), cfg.block
    )
    fn = functools.partial(
        _shard_fn,
        cfg=cfg,
        num_shards=num_shards,
        capacity=capacity,
        bucket_bits=bucket_bits,
        method=method,
        overlap=overlap,
    )
    mkeys, midx, counts, overflow = jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(ROW_AXIS), P()),
        out_specs=(P(ROW_AXIS), P(ROW_AXIS), P(ROW_AXIS), P()),
    )(keys, n_live)
    num = num_shards
    return (
        mkeys.reshape(num, -1),
        midx.reshape(num, -1),
        counts.reshape(num),
        overflow,
    )


def dist_sort_pairs(
    keys: jax.Array,
    mesh,
    cfg: EngineConfig | None = None,
    bucket_bits: int = 12,
    cap_factor: float = 2.0,
    method: str = "auto",
    n_live: int | None = None,
    auto_retry: bool = True,
    overlap: bool = False,
) -> ShardedSort:
    """Distributed stable sort of (key, original-index) pairs over a mesh.

    ``keys``: (n,) uint32, n divisible by num_shards * cfg.block (pad with
    PAD_KEY via core.table.pad_to_tile to arrange this).  Returns per-shard
    sorted runs; ``gather_sorted`` assembles the global result on host.

    Skew recovery: on capacity overflow the exchange is retried with a
    doubled ``cap_factor`` (up to full-gather capacity, at which point any
    distribution fits — an all-equal keyset lands on one shard and still
    succeeds untuned).  Pass ``auto_retry=False`` to surface the first
    overflow instead.

    ``overlap=True`` selects the ring exchange schedule (P-1 ppermute
    rounds with merge-as-you-receive) instead of the monolithic all_to_all
    + merge tree — same semantics, same stability; see the module docstring
    for when each wins.
    """
    cfg = cfg or EngineConfig()
    method = resolve_method(method)
    num_shards = mesh.shape[ROW_AXIS]
    n = keys.shape[0]
    if n % (num_shards * cfg.block):
        raise ValueError(
            f"n={n} must be a multiple of num_shards*block="
            f"{num_shards * cfg.block}; pad first"
        )
    if bucket_bits < 1 or bucket_bits > 20:
        raise ValueError("bucket_bits must be in [1, 20]")
    if n_live is None:
        n_live = n
    n_local = n // num_shards
    while True:
        mkeys, midx, counts, overflow = _dist_sort_padded(
            keys, jnp.uint32(n_live), mesh, cfg, bucket_bits, cap_factor,
            method,
        )
        capacity_full = int(cap_factor) >= num_shards or round_up(
            max(1, int(n_local * cap_factor) // num_shards), cfg.block
        ) >= n_local
        if not auto_retry or not bool(overflow) or capacity_full:
            break
        cap_factor *= 2.0
    return ShardedSort(mkeys, midx, counts, overflow)


def gather_sorted(result: ShardedSort) -> tuple:
    """Host-side assembly: concatenate live prefixes in shard order."""
    import numpy as np

    if bool(result.overflow):
        raise RuntimeError(
            "distributed sort overflowed shard capacity; retry with larger "
            "cap_factor or more bucket_bits"
        )
    keys = np.asarray(result.keys)
    idx = np.asarray(result.index)
    counts = np.asarray(result.counts)
    out_k = np.concatenate([keys[s, : counts[s]] for s in range(len(counts))])
    out_i = np.concatenate([idx[s, : counts[s]] for s in range(len(counts))])
    return out_k, out_i
