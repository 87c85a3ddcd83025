"""Filter / group-by aggregate / join operators vs. numpy oracles."""

import jax.numpy as jnp
import numpy as np
import pytest

from gpuradixsort.config import EngineConfig
from gpuradixsort.core.table import make_key_column, table_from_arrays
from gpuradixsort.ops.aggregate import group_by_aggregate
from gpuradixsort.ops.filter import filter_table
from gpuradixsort.ops.join import join

CFG = EngineConfig()


def _table(rng, n, hi=1000):
    keys = rng.integers(0, hi, size=n, dtype=np.uint32)
    vals = rng.integers(-100, 100, size=n).astype(np.int32)
    tbl = table_from_arrays(CFG, val=vals)
    tbl = tbl.with_column("key", make_key_column(keys, CFG))
    return tbl, keys, vals


@pytest.mark.parametrize("n", [16, 1000, 4096, 5000])
def test_filter_matches_numpy(n, rng):
    tbl, keys, vals = _table(rng, n)
    sel = filter_table(tbl, lambda t: t["key"].data < 300, CFG)
    out = sel.to_table()
    mask = keys < 300
    assert out.length == int(mask.sum())
    np.testing.assert_array_equal(out["key"].to_numpy(), keys[mask])
    np.testing.assert_array_equal(out["val"].to_numpy(), vals[mask])


def test_filter_none_and_all(rng):
    tbl, keys, vals = _table(rng, 1000)
    none = filter_table(tbl, lambda t: t["key"].data < 0, CFG).to_table()
    assert none.length == 0
    alln = filter_table(
        tbl, lambda t: jnp.ones_like(t["key"].data, jnp.bool_), CFG
    ).to_table()
    assert alln.length == 1000
    np.testing.assert_array_equal(alln["key"].to_numpy(), keys)


@pytest.mark.parametrize("n,groups", [(1000, 10), (5000, 257), (4096, 1)])
def test_group_by_aggregate(n, groups, rng):
    tbl, keys, vals = _table(rng, n, hi=groups)
    sel = group_by_aggregate(
        tbl,
        "key",
        {
            "total": ("val", "sum"),
            "cnt": ("val", "count"),
            "lo": ("val", "min"),
            "hi": ("val", "max"),
            "avg": ("val", "mean"),
        },
        CFG,
    )
    out = sel.to_table()
    uniq = np.unique(keys)
    assert out.length == len(uniq)
    np.testing.assert_array_equal(out["key"].to_numpy(), uniq)
    for i, k in enumerate(uniq):
        grp = vals[keys == k]
        assert out["total"].to_numpy()[i] == grp.sum(), f"sum key={k}"
        assert out["cnt"].to_numpy()[i] == len(grp)
        assert out["lo"].to_numpy()[i] == grp.min()
        assert out["hi"].to_numpy()[i] == grp.max()
        np.testing.assert_allclose(
            out["avg"].to_numpy()[i], grp.mean(), rtol=1e-6
        )


def test_join_inner_semi_anti(rng):
    nb, np_ = 500, 3000
    build_keys = rng.permutation(10_000)[:nb].astype(np.uint32)  # unique
    build_payload = rng.integers(0, 1 << 30, size=nb).astype(np.int32)
    probe_keys = rng.integers(0, 10_000, size=np_, dtype=np.uint32)
    probe_payload = rng.integers(0, 1 << 30, size=np_).astype(np.int32)

    build = table_from_arrays(CFG, payload=build_payload)
    build = build.with_column("key", make_key_column(build_keys, CFG))
    probe = table_from_arrays(CFG, pval=probe_payload)
    probe = probe.with_column("key", make_key_column(probe_keys, CFG))

    lookup = dict(zip(build_keys.tolist(), build_payload.tolist()))
    exp_mask = np.array([k in lookup for k in probe_keys])

    inner = join(probe, build, "key", "inner", CFG, validate_unique=True).to_table()
    assert inner.length == int(exp_mask.sum())
    np.testing.assert_array_equal(inner["key"].to_numpy(), probe_keys[exp_mask])
    np.testing.assert_array_equal(inner["pval"].to_numpy(), probe_payload[exp_mask])
    np.testing.assert_array_equal(
        inner["build_payload"].to_numpy(),
        np.array([lookup[k] for k in probe_keys[exp_mask]], dtype=np.int32),
    )

    semi = join(probe, build, "key", "semi", CFG).to_table()
    np.testing.assert_array_equal(semi["key"].to_numpy(), probe_keys[exp_mask])

    anti = join(probe, build, "key", "anti", CFG).to_table()
    np.testing.assert_array_equal(anti["key"].to_numpy(), probe_keys[~exp_mask])


def test_join_duplicate_build_detection(rng):
    build_keys = np.array([5, 5, 7], dtype=np.uint32)
    build = table_from_arrays(CFG, payload=np.arange(3, dtype=np.int32))
    build = build.with_column("key", make_key_column(build_keys, CFG))
    probe = table_from_arrays(CFG, pval=np.arange(4, dtype=np.int32))
    probe = probe.with_column(
        "key", make_key_column(np.array([5, 6, 7, 8], dtype=np.uint32), CFG)
    )
    with pytest.raises(ValueError, match="duplicate"):
        join(probe, build, "key", "inner", CFG, validate_unique=True)


def test_filter_then_sort_pipeline(rng):
    # Config 3 analog: predicate pushdown + sort on the survivors.
    from gpuradixsort.ops.sort import sort_table

    tbl, keys, vals = _table(rng, 3000, hi=1 << 16)
    sel = filter_table(tbl, lambda t: (t["key"].data & 1) == 0, CFG)
    out = sort_table(sel.to_table(), "key", CFG)
    expect = np.sort(keys[keys % 2 == 0])
    np.testing.assert_array_equal(out["key"].to_numpy(), expect)


def test_sort_after_selective_filter(rng):
    # A filter keeps its input's buffer; when few rows survive, that buffer
    # is several blocks longer than the live rows rounded up to one block,
    # and the sort's index column must still match it.
    from gpuradixsort.ops.sort import sort_pairs, sort_table

    tbl, keys, vals = _table(rng, 5 * CFG.block, hi=1 << 20)
    sel = filter_table(tbl, lambda t: t["key"].data < 1000, CFG).to_table()
    mask = keys < 1000
    out = sort_table(sel, "key", CFG)
    order = np.argsort(keys[mask], kind="stable")
    np.testing.assert_array_equal(out["key"].to_numpy(), keys[mask][order])
    np.testing.assert_array_equal(out["val"].to_numpy(), vals[mask][order])
    _, perm = sort_pairs(sel["key"], CFG, method="radix")
    np.testing.assert_array_equal(perm.to_numpy(), order.astype(np.uint32))


class TestAggregateNumerics:
    """Adversarial aggregation numerics (segment-local, not global-cumsum)."""

    def test_int32_wraparound_magnitudes(self, rng):
        n = 100_000
        keys = rng.integers(0, 50, n, dtype=np.uint32)
        vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
        tbl = table_from_arrays(CFG, k=keys, v=vals)
        tbl = tbl.with_column("k", make_key_column(keys, CFG))
        sel = group_by_aggregate(tbl, "k", {"s": ("v", "sum")}, CFG)
        out = sel.to_table()
        uniq = np.unique(keys)
        # numpy int32 wrap semantics == segment-local int32 sums.
        want = np.array(
            [vals[keys == g].sum(dtype=np.int32) for g in uniq], np.int32
        )
        np.testing.assert_array_equal(out["k"].to_numpy(), uniq)
        np.testing.assert_array_equal(out["s"].to_numpy(), want)

    def test_float32_precision_large_n(self, rng):
        # A global float32 cumsum over 1M rows loses ~all group precision;
        # segment-local sums stay within float32 tree-sum error of the
        # float64 oracle.
        n = 1_000_000
        keys = rng.integers(0, 1000, n, dtype=np.uint32)
        vals = (rng.random(n).astype(np.float32) * 1e6).astype(np.float32)
        tbl = table_from_arrays(CFG, k=keys, v=vals)
        tbl = tbl.with_column("k", make_key_column(keys, CFG))
        sel = group_by_aggregate(
            tbl, "k", {"s": ("v", "sum"), "m": ("v", "mean")}, CFG
        )
        out = sel.to_table()
        uniq = np.unique(keys)
        want = np.array([vals[keys == g].sum(dtype=np.float64) for g in uniq])
        got = out["s"].to_numpy().astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-5)
        want_m = np.array(
            [vals[keys == g].mean(dtype=np.float64) for g in uniq]
        )
        np.testing.assert_allclose(
            out["m"].to_numpy().astype(np.float64), want_m, rtol=1e-5
        )

    def test_mean_of_large_ints(self, rng):
        n = 10_000
        keys = rng.integers(0, 8, n, dtype=np.uint32)
        vals = rng.integers(0, 2**30, n).astype(np.int32)
        tbl = table_from_arrays(CFG, k=keys, v=vals)
        tbl = tbl.with_column("k", make_key_column(keys, CFG))
        sel = group_by_aggregate(tbl, "k", {"m": ("v", "mean")}, CFG)
        out = sel.to_table()
        uniq = np.unique(keys)
        want = np.array([vals[keys == g].mean() for g in uniq])
        np.testing.assert_allclose(
            out["m"].to_numpy().astype(np.float64), want, rtol=1e-4
        )


class TestJoinExpand:
    """One-to-many join via run expansion (duplicate build keys)."""

    def _oracle(self, pk, pv, bk, bv):
        # All (probe, build) matches ordered by probe row, then by build
        # position in the key-sorted build side.
        order = np.argsort(bk, kind="stable")
        bk_s, bv_s = bk[order], bv[order]
        rows = []
        for i in range(len(pk)):
            lo = np.searchsorted(bk_s, pk[i], side="left")
            hi = np.searchsorted(bk_s, pk[i], side="right")
            for j in range(lo, hi):
                rows.append((pk[i], pv[i], bv_s[j]))
        return rows

    def test_duplicates_and_misses(self, rng):
        from gpuradixsort.ops.join import join_expand

        n_p, n_b = 500, 300
        pk = rng.integers(0, 50, n_p, dtype=np.uint32)
        bk = rng.integers(0, 50, n_b, dtype=np.uint32)  # heavy duplicates
        pv = rng.integers(0, 2**31, n_p).astype(np.int32)
        bv = rng.integers(0, 2**31, n_b).astype(np.int32)
        probe = table_from_arrays(CFG, k=pk, pv=pv)
        probe = probe.with_column("k", make_key_column(pk, CFG))
        build = table_from_arrays(CFG, k=bk, bv=bv)
        build = build.with_column("k", make_key_column(bk, CFG))

        want = self._oracle(pk, pv, bk, bv)
        res = join_expand(probe, build, "k", CFG, capacity=len(want) + 100)
        assert not bool(res.overflow)
        assert int(res.count) == len(want)
        out = res.to_table()
        got = list(
            zip(
                out["k"].to_numpy().tolist(),
                out["pv"].to_numpy().tolist(),
                out["build_bv"].to_numpy().tolist(),
            )
        )
        assert got == [(int(a), int(b), int(c)) for a, b, c in want]

    def test_overflow_flag(self, rng):
        from gpuradixsort.ops.join import join_expand

        n = 200
        pk = np.full(n, 7, dtype=np.uint32)
        bk = np.full(n, 7, dtype=np.uint32)  # n*n matches
        probe = table_from_arrays(CFG, k=pk)
        probe = probe.with_column("k", make_key_column(pk, CFG))
        build = table_from_arrays(CFG, k=bk)
        build = build.with_column("k", make_key_column(bk, CFG))
        res = join_expand(probe, build, "k", CFG, capacity=1000)
        assert bool(res.overflow)
        assert int(res.count) == n * n
        with pytest.raises(RuntimeError, match="capacity"):
            res.to_table()

    def test_unique_build_matches_plain_join(self, rng):
        from gpuradixsort.ops.join import join_expand

        n_p, n_b = 400, 100
        bk = rng.permutation(1000)[:n_b].astype(np.uint32)  # unique
        pk = rng.choice(np.concatenate([bk, np.arange(2000, 2100, dtype=np.uint32)]), n_p)
        bv = rng.integers(0, 2**31, n_b).astype(np.int32)
        probe = table_from_arrays(CFG, k=pk.astype(np.uint32))
        probe = probe.with_column("k", make_key_column(pk.astype(np.uint32), CFG))
        build = table_from_arrays(CFG, k=bk, bv=bv)
        build = build.with_column("k", make_key_column(bk, CFG))
        inner = join(probe, build, "k", how="inner", cfg=CFG).to_table()
        res = join_expand(probe, build, "k", CFG).to_table()
        np.testing.assert_array_equal(
            res["k"].to_numpy(), inner["k"].to_numpy()
        )
        np.testing.assert_array_equal(
            res["build_bv"].to_numpy(), inner["build_bv"].to_numpy()
        )
