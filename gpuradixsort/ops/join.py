"""Equi-join of columnar tables on uint32 keys (BASELINE.json config 5).

No reference equivalent (the reference only sorts).  Design: a sort-probe
join — sort the build side by key once (the engine's own stable sort), then
every probe row finds its match with a vectorized binary search
(``jnp.searchsorted``), which is log2(N) sequential gathers of fully
vectorized probe batches; no hash table.  The role a radix-partitioned hash
join usually plays is served here by the sort + searchsorted pair.

Supported: inner / semi / anti probe-side joins.  A build side with duplicate
keys uses run expansion (``join_expand``): each probe row matches a sorted
build-key *run*, output rows are enumerated into a static-capacity buffer
with a validity count — the engine's own 0xffffffff padded-output trick
(XLA static shapes; dynamic result sizes ride as device scalars).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from gpuradixsort.config import EngineConfig
from gpuradixsort.core.table import Column, Table, round_up
from gpuradixsort.ops.filter import Selection, filter_table
from gpuradixsort.ops.sort import sort_table


def join(
    probe: Table,
    build: Table,
    key: str,
    how: str = "inner",
    cfg: EngineConfig | None = None,
    validate_unique: bool = False,
    build_prefix: str = "build_",
) -> Selection:
    """Join ``probe`` rows against ``build`` rows on uint32 column ``key``.

    - ``inner``: probe rows with a build match, plus the build payload
      columns (named ``build_<name>``).
    - ``semi``: probe rows with a build match, probe columns only.
    - ``anti``: probe rows without a build match.

    Build keys must be unique for ``inner`` (each probe row matches at most
    one build row); set ``validate_unique=True`` to check (host sync).
    """
    cfg = cfg or EngineConfig()
    if how not in ("inner", "semi", "anti"):
        raise ValueError(f"unknown join type: {how}")

    build_sorted = sort_table(build, key, cfg)
    bkeys = build_sorted[key].valid()  # static slice: live prefix
    nb = build.length
    if validate_unique and nb > 1:
        dup = bool(jnp.any(bkeys[1:] == bkeys[:-1]))
        if dup:
            raise ValueError(
                "build side has duplicate keys; use join_expand for "
                "one-to-many joins"
            )

    pkeys = probe[key].data  # padded; pad rows filtered out below
    pos = jnp.searchsorted(bkeys, pkeys, side="left").astype(jnp.int32)
    safe_pos = jnp.clip(pos, 0, max(nb - 1, 0))
    matched = (pos < nb) & (jnp.take(bkeys, safe_pos, mode="clip") == pkeys)
    # A probe key equal to the pad sentinel can only match a real build row
    # (bkeys holds live rows only), so no pad-collision handling is needed;
    # probe pad rows are dropped by filter_table's live mask.

    if how == "inner":
        cols = dict(probe.columns)
        for name in build_sorted.names():
            if name == key:
                continue
            col = build_sorted[name]
            gathered = jnp.take(col.data, safe_pos, axis=0, mode="clip")
            cols[build_prefix + name] = Column(gathered, probe.length)
        joined = Table(cols)
        keep = matched
    elif how == "semi":
        joined = probe
        keep = matched
    else:  # anti
        joined = probe
        keep = ~matched

    return filter_table(joined, lambda _t: keep, cfg)


@dataclasses.dataclass(frozen=True)
class ExpandedJoin:
    """One-to-many join result: padded rows + live count + overflow flag.

    ``table`` holds ``capacity`` rows; rows >= ``count`` are padding.  If
    ``overflow`` is True the total match count exceeded the capacity and the
    output was truncated — retry with a larger ``capacity``.
    """

    table: Table
    count: jax.Array  # int32 scalar, number of live output rows
    overflow: jax.Array  # bool scalar

    def to_table(self) -> Table:
        if bool(self.overflow):
            raise RuntimeError(
                "join_expand output exceeded capacity; retry with a larger "
                "capacity"
            )
        n = int(self.count)
        return Table(
            {
                name: Column(col.data, n)
                for name, col in self.table.columns.items()
            }
        )


def join_expand(
    probe: Table,
    build: Table,
    key: str,
    cfg: EngineConfig | None = None,
    capacity: int | None = None,
    build_prefix: str = "build_",
) -> ExpandedJoin:
    """Inner join supporting duplicate build keys (run expansion).

    Each probe row matches the run of equal keys in the sorted build side;
    output rows are (probe row, build row) pairs ordered by probe row, then
    build order within the run — fully deterministic.  Output size is
    data-dependent, so rows land in a static ``capacity`` buffer with a
    device-scalar live count (the padded-output pattern the engine uses
    everywhere, after the reference's 0xffffffff tail convention,
    ``OriginalDataToIntermediateData.comp:44-47``).

    ``capacity`` defaults to the probe's padded length (exact for join
    selectivity <= 1 match/row); the ``overflow`` flag reports truncation.
    """
    cfg = cfg or EngineConfig()
    build_sorted = sort_table(build, key, cfg)
    bkeys = build_sorted[key].valid()
    nb = build.length

    np_len = probe.length
    pkeys = probe[key].data
    padded = probe[key].padded_length
    live = jnp.arange(padded, dtype=jnp.int32) < np_len

    lo = jnp.searchsorted(bkeys, pkeys, side="left").astype(jnp.int32)
    hi = jnp.searchsorted(bkeys, pkeys, side="right").astype(jnp.int32)
    cnt = jnp.where(live, hi - lo, 0)
    offsets = jnp.cumsum(cnt) - cnt  # exclusive, in probe-row order
    total = jnp.sum(cnt)

    if capacity is None:
        capacity = padded
    capacity = round_up(capacity, cfg.block)
    overflow = total > capacity

    # Enumerate output slots: slot j belongs to the probe row whose offset
    # range contains j; its match ordinal picks the build row from the run.
    slots = jnp.arange(capacity, dtype=jnp.int32)
    prow = (
        jnp.searchsorted(offsets + cnt, slots, side="right")
        .astype(jnp.int32)
        .clip(0, padded - 1)
    )
    ordinal = slots - jnp.take(offsets, prow, mode="clip")
    brow = jnp.take(lo, prow, mode="clip") + ordinal
    valid = slots < jnp.minimum(total, capacity)
    safe_brow = jnp.clip(brow, 0, max(nb - 1, 0))

    cols: dict[str, Column] = {}
    for name in probe.names():
        g = jnp.take(probe[name].data, prow, axis=0, mode="clip")
        g = jnp.where(
            valid.reshape((-1,) + (1,) * (g.ndim - 1)), g, jnp.zeros_like(g)
        )
        cols[name] = Column(g, capacity)
    for name in build_sorted.names():
        if name == key:
            continue
        g = jnp.take(build_sorted[name].data, safe_brow, axis=0, mode="clip")
        g = jnp.where(
            valid.reshape((-1,) + (1,) * (g.ndim - 1)), g, jnp.zeros_like(g)
        )
        cols[build_prefix + name] = Column(g, capacity)
    return ExpandedJoin(Table(cols), total, overflow)
