"""Run the engine's main path once on NVIDIA GPUs and check it against numpy.

    python chip_smoke.py              # one card: the six phases below
    python chip_smoke.py --chips 4    # four cards: the distributed operators

Every phase calls the entry points a user calls, on data made from
``--seed``, and compares the output with a numpy reference built on the host.
Sizes come from the BASELINE.json configs; cuts are in brackets.

One card (``jax.devices()[0]``):

================  ==============================  ===========================
phase             entry point                     size
================  ==============================  ===========================
reference_sort    ``sort_pairs`` (auto, radix)    1,000,000 keys: shuffled
                                                  0..999,999, 4-bit digits
large_sort        ``sort_pairs``                  100M random uint32 keys
                                                  [cut from 1B]
payload_sort      ``sort_table``                  16M rows x (uint32 key +
                                                  16 x int32), 64-byte rows
filter_sort       ``filter_table`` ->             100M rows
                  ``sort_table``
group_by          ``group_by_aggregate``          100M rows, 1M groups [cut
                                                  from 1B rows]: int32 sum,
                                                  count, float32 mean
join              ``join(how="inner")``           unique build 10M / probe
                                                  100M [cut from 100M / 1B]
================  ==============================  ===========================

Four cards (``make_row_mesh(4)``): ``dist_sort_pairs`` over 64M keys,
``dist_group_by_aggregate`` over 64M rows in 1M groups, ``dist_join_inner``
of a unique 8M-row build side with a 64M-row probe side, one uint32 payload
per side.

Every check is exact, except the group-by mean (float32 sums added in
another order than numpy's, so rtol 1e-5).  Each phase prints its wall time
(ended with ``block_until_ready``; ``first_s`` includes compilation,
``warm_s`` is a second call) and the device's ``peak_bytes_in_use`` so far;
the two largest phases also print ``compiled.memory_analysis()``.  The
script exits non-zero, without the result line, when JAX finds no GPU or any
phase fails.  Otherwise the last line of stdout is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from gpuradixsort.core.table import Table, make_column, make_key_column
from gpuradixsort.ops.aggregate import group_by_aggregate
from gpuradixsort.ops.filter import filter_table
from gpuradixsort.ops.join import join
from gpuradixsort.ops.sort import sort_pairs, sort_table
from gpuradixsort.parallel.dist_ops import (
    dist_group_by_aggregate,
    dist_join_inner,
    gather_groups,
    gather_join,
)
from gpuradixsort.parallel.dist_sort import dist_sort_pairs, gather_sorted
from gpuradixsort.parallel.mesh import make_row_mesh, shard_rows
from gpuradixsort.utils.device import (
    card_name_and_power_limit,
    device_summary,
    enable_compile_cache,
    peak_bytes_in_use,
    require_gpu,
)

M = 1 << 20


def _timed(fn, *args):
    """Call ``fn`` twice, each ended with block_until_ready.

    Returns (output of the second call, {"first_s", "warm_s"}).
    """
    times = {}
    for label in ("first_s", "warm_s"):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times[label] = time.perf_counter() - t0
    return out, times


def _compiled(fn, *args):
    """jit + compile ``fn`` for ``args``; returns (compiled, memory analysis)."""
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, compiled.memory_analysis()


def _equal(got, want, what: str) -> None:
    np.testing.assert_array_equal(np.asarray(got), want, err_msg=what)


def _unique_keys(rng, n: int) -> np.ndarray:
    """n distinct uint32 keys in shuffled order.

    An odd multiplier is a bijection mod 2**32, so distinct inputs stay
    distinct.
    """
    base = rng.permutation(n).astype(np.uint64)
    return ((base * np.uint64(2654435761)) % np.uint64(1 << 32)).astype(
        np.uint32
    )


def _probe_keys(rng, build_keys: np.ndarray, n: int) -> np.ndarray:
    """Half drawn from the build side (hits), half uniform (almost all misses)."""
    hits = build_keys[rng.integers(0, build_keys.shape[0], n)]
    other = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    return np.where(rng.random(n) < 0.5, hits, other)


def _group_reference(keys, ival, fval, groups):
    """numpy group-by: (group keys, int32 sums, counts, float64 means).

    float64 bincount sums of int32 values are exact below 2**53; the cast
    through int64 to int32 wraps exactly like int32 accumulation does.
    """
    counts = np.bincount(keys, minlength=groups)
    uniq = np.flatnonzero(counts)
    sums = np.bincount(keys, weights=ival, minlength=groups)
    sums = sums.astype(np.int64).astype(np.int32)
    out = [uniq.astype(np.uint32), sums[uniq], counts[uniq]]
    if fval is not None:
        fsum = np.bincount(keys, weights=fval.astype(np.float64),
                           minlength=groups)
        out.append(fsum[uniq] / counts[uniq])
    return out


def _join_reference(pk, pv, bk, bv):
    """Probe rows with a build match, in probe order, plus the build payload."""
    order = np.argsort(bk)
    bks = bk[order]
    pos = np.minimum(np.searchsorted(bks, pk), bks.shape[0] - 1)
    hit = bks[pos] == pk
    return pk[hit], pv[hit], bv[order][pos[hit]]


# -- one-card phases --------------------------------------------------------

def phase_reference_sort(rng, n: int = 1_000_000) -> dict:
    keys = rng.permutation(n).astype(np.uint32)
    dev = jnp.asarray(keys)
    want_perm = np.argsort(keys, kind="stable").astype(np.uint32)
    info = {"rows": n}
    for method in ("auto", "radix"):
        (s, p), t = _timed(
            lambda k: [c.data for c in sort_pairs(k, method=method)], dev
        )
        _equal(s[:n], np.arange(n, dtype=np.uint32), f"{method} keys")
        _equal(p[:n], want_perm, f"{method} permutation")
        info.update({f"{method}_{k}": v for k, v in t.items()})
    return info


def phase_large_sort(rng, n: int = 100_000_000) -> dict:
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    dev = jnp.asarray(keys)
    (s, p), t = _timed(lambda k: [c.data for c in sort_pairs(k)], dev)
    order = np.argsort(keys, kind="stable")
    _equal(s[:n], keys[order], "sorted keys")
    _equal(p[:n], order.astype(np.uint32), "permutation")
    return {"rows": n, **t}


def phase_payload_sort(rng, n: int = 16 * M) -> dict:
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    payload = rng.integers(-(1 << 31), 1 << 31, (n, 16), dtype=np.int32)
    dev = (jnp.asarray(keys), jnp.asarray(payload))

    def step(k, pay):
        tbl = Table({"key": make_key_column(k), "payload": make_column(pay)})
        out = sort_table(tbl, "key")
        return out["key"].data, out["payload"].data

    (sk, sp), t = _timed(step, *dev)
    order = np.argsort(keys, kind="stable")
    _equal(sk[:n], keys[order], "sorted keys")
    _equal(sp[:n], payload[order], "payload rows")
    return {"rows": n, **t}


def phase_filter_sort(rng, n: int = 100_000_000) -> dict:
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    dev = jnp.asarray(keys)
    threshold = np.uint32(1 << 31)

    def step(k):
        tbl = Table({"key": make_key_column(k)})
        sel = filter_table(tbl, lambda t: t["key"].data < threshold)
        return sort_table(sel.to_table(), "key")["key"].valid()

    got, t = _timed(step, dev)
    want = np.sort(keys[keys < threshold])
    _equal(got, want, "filtered, sorted keys")
    return {"rows": n, "selected": int(want.shape[0]), **t}


def _group_by_step(keys, ival, fval):
    tbl = Table({
        "k": make_key_column(keys),
        "i": make_column(ival),
        "f": make_column(fval),
    })
    sel = group_by_aggregate(
        tbl, "k", {"s": ("i", "sum"), "c": ("i", "count"), "m": ("f", "mean")}
    )
    return sel.count, {name: c.data for name, c in sel.table.columns.items()}


def phase_group_by(rng, n: int = 100_000_000, groups: int = 1_000_000) -> dict:
    keys = rng.integers(0, groups, n, dtype=np.uint32)
    ival = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int32)
    fval = rng.random(n, dtype=np.float32)
    dev = tuple(jnp.asarray(a) for a in (keys, ival, fval))
    t0 = time.perf_counter()
    compiled, mem = _compiled(_group_by_step, *dev)
    compile_s = time.perf_counter() - t0
    (count, cols), t = _timed(compiled, *dev)
    uniq, sums, counts, means = _group_reference(keys, ival, fval, groups)
    g = int(count)
    _equal(g, uniq.shape[0], "group count")
    _equal(cols["k"][:g], uniq, "group keys")
    _equal(cols["s"][:g], sums, "int32 sums")
    _equal(cols["c"][:g], counts.astype(np.int32), "counts")
    np.testing.assert_allclose(
        np.asarray(cols["m"][:g]), means, rtol=1e-5, err_msg="float32 means"
    )
    return {"rows": n, "groups": g, "compile_s": compile_s, **t,
            "memory_analysis": mem}


def _join_step(pk, pv, bk, bv):
    probe = Table({"key": make_key_column(pk), "pv": make_column(pv)})
    build = Table({"key": make_key_column(bk), "bv": make_column(bv)})
    sel = join(probe, build, "key", how="inner")
    return sel.count, {name: c.data for name, c in sel.table.columns.items()}


def phase_join(rng, n_build: int = 10_000_000,
               n_probe: int = 100_000_000) -> dict:
    bk = _unique_keys(rng, n_build)
    bv = rng.integers(-(1 << 31), 1 << 31, n_build, dtype=np.int32)
    pk = _probe_keys(rng, bk, n_probe)
    pv = rng.integers(-(1 << 31), 1 << 31, n_probe, dtype=np.int32)
    dev = tuple(jnp.asarray(a) for a in (pk, pv, bk, bv))
    t0 = time.perf_counter()
    compiled, mem = _compiled(_join_step, *dev)
    compile_s = time.perf_counter() - t0
    (count, cols), t = _timed(compiled, *dev)
    want_k, want_pv, want_bv = _join_reference(pk, pv, bk, bv)
    m = int(count)
    _equal(m, want_k.shape[0], "match count")
    _equal(cols["key"][:m], want_k, "joined keys")
    _equal(cols["pv"][:m], want_pv, "probe payload")
    _equal(cols["build_bv"][:m], want_bv, "build payload")
    return {"rows": n_probe + n_build, "matches": m, "compile_s": compile_s,
            **t, "memory_analysis": mem}


# -- four-card phases -------------------------------------------------------

def phase_dist_sort(rng, mesh, n: int = 64 * M) -> dict:
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    dev = shard_rows(mesh, jnp.asarray(keys))
    (s, p), t = _timed(lambda k: gather_sorted(dist_sort_pairs(k, mesh)), dev)
    order = np.argsort(keys, kind="stable")
    _equal(s, keys[order], "sorted keys")
    _equal(p, order.astype(np.uint32), "permutation")
    return {"rows": n, **t}


def phase_dist_group_by(rng, mesh, n: int = 64 * M,
                        groups: int = 1_000_000) -> dict:
    keys = rng.integers(0, groups, n, dtype=np.uint32)
    vals = rng.integers(-(1 << 31), 1 << 31, n, dtype=np.int32)
    k_dev, v_dev = shard_rows(mesh, jnp.asarray(keys), jnp.asarray(vals))

    def step(k, v):
        res = dist_group_by_aggregate(
            k, {"v": v}, {"s": ("v", "sum"), "c": ("v", "count")}, mesh
        )
        return gather_groups(res)

    (gk, gv), t = _timed(step, k_dev, v_dev)
    uniq, sums, counts = _group_reference(keys, vals, None, groups)
    _equal(gk, uniq, "group keys")
    _equal(gv["s"], sums, "int32 sums")
    _equal(gv["c"], counts.astype(np.int32), "counts")
    return {"rows": n, "groups": int(uniq.shape[0]), **t}


def phase_dist_join(rng, mesh, n_build: int = 8 * M,
                    n_probe: int = 64 * M) -> dict:
    bk = _unique_keys(rng, n_build)
    bv = rng.integers(0, 1 << 32, n_build, dtype=np.uint32)
    pk = _probe_keys(rng, bk, n_probe)
    pv = rng.integers(0, 1 << 32, n_probe, dtype=np.uint32)
    dev = shard_rows(mesh, *(jnp.asarray(a) for a in (pk, pv, bk, bv)))
    (k, opv, obv), t = _timed(
        lambda *a: gather_join(dist_join_inner(*a, mesh)), *dev
    )
    want_k, want_pv, want_bv = _join_reference(pk, pv, bk, bv)
    # Output rows are key-ordered across shards; order ties by probe payload
    # on both sides (a build key is unique, so it fixes the build payload).
    got_order = np.lexsort((opv, k))
    want_order = np.lexsort((want_pv, want_k))
    _equal(k[got_order], want_k[want_order], "joined keys")
    _equal(opv[got_order], want_pv[want_order], "probe payload")
    _equal(obv[got_order], want_bv[want_order], "build payload")
    return {"rows": n_probe + n_build, "matches": int(k.shape[0]), **t}


ONE_CARD_PHASES = {
    "reference_sort": phase_reference_sort,
    "large_sort": phase_large_sort,
    "payload_sort": phase_payload_sort,
    "filter_sort": phase_filter_sort,
    "group_by": phase_group_by,
    "join": phase_join,
}

FOUR_CARD_PHASES = {
    "dist_sort": phase_dist_sort,
    "dist_group_by": phase_dist_group_by,
    "dist_join": phase_dist_join,
}


def _report(name: str, info: dict, devices) -> None:
    mem = info.pop("memory_analysis", None)
    peaks = [peak_bytes_in_use(d) for d in devices]
    fields = " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in info.items()
    )
    print(f"[smoke] {name}: {fields} peak_bytes_in_use={peaks}", flush=True)
    if mem is not None:
        print(
            f"[smoke] {name} memory_analysis: "
            f"argument={mem.argument_size_in_bytes} "
            f"output={mem.output_size_in_bytes} "
            f"temp={mem.temp_size_in_bytes} "
            f"alias={mem.alias_size_in_bytes}",
            flush=True,
        )


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1)
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    devices = require_gpu(args.chips)
    enable_compile_cache()
    summary = device_summary()
    print(f"[smoke] jax.devices(): {jax.devices()}", flush=True)
    print(f"[smoke] device_kind={summary['kind']} count={summary['count']}",
          flush=True)
    for line in card_name_and_power_limit():
        print(line, flush=True)

    if args.chips == 4:
        mesh = make_row_mesh(4)
        phases = {
            name: functools.partial(phase, mesh=mesh)
            for name, phase in FOUR_CARD_PHASES.items()
        }
    else:
        phases = ONE_CARD_PHASES
    for i, (name, phase) in enumerate(phases.items()):
        rng = np.random.default_rng([args.seed, i])
        _report(name, phase(rng), devices)

    print(json.dumps({"ok": True, "device": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
