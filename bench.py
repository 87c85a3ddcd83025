"""Benchmark: stable (key, index) sort on one GPU, per method, + 64B rows.

Mirrors the reference's headline workload — 1,048,576 padded uint32
key+index pairs sorted stably in 6,165 us (~170.1 M keys/s) on a 2017-era
GPU (``durations.txt:1``, ``Include/ComputeControllers/ParallelSort.h:39``).
Times the jitted ``sort_pairs`` entry point with every method at 1,048,576
and 100M random keys (the measurement behind ``resolve_method``), then the
64-byte-row table sort (BASELINE config 2: uint32 key + 16 x int32) at
1,048,576 rows.  Every output is checked against numpy.  Also logs the
custom calls XLA lowers the ``xla`` pair sort to.

Each time is the median of several calls, each ended with
``block_until_ready``, after one warm-up call.  Diagnostics go to stderr;
stdout gets the card's name and power limit and, last, ONE JSON line (the
1M headline, best method, with the device).  Exits non-zero when JAX finds
no GPU or any output is wrong.

    python bench.py
"""

from __future__ import annotations

import json
import re
import statistics
import sys

import jax
import jax.numpy as jnp
import numpy as np

from gpuradixsort.core.table import Table, make_column, make_key_column
from gpuradixsort.ops.sort import METHODS, sort_pairs, sort_table
from gpuradixsort.utils.device import (
    card_name_and_power_limit,
    device_summary,
    enable_compile_cache,
    require_gpu,
    time_call,
)

# Reference baseline: 1,048,576 pairs / 6,165 us (durations.txt:1).
HEADLINE_N = 1 << 20
BASELINE_KEYS_PER_S = HEADLINE_N / 6.165e-3

SIZES = (HEADLINE_N, 100_000_000)
REPS = {HEADLINE_N: 20, 100_000_000: 5}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pair_sort(method: str):
    return jax.jit(lambda k: [c.data for c in sort_pairs(k, method=method)])


def custom_call_targets(fn, *args) -> list[str]:
    hlo = fn.lower(*args).compile().as_text()
    return sorted(set(re.findall(r'custom_call_target="([^"]+)"', hlo)))


def check_pairs(fn, keys_dev, keys: np.ndarray, method: str) -> None:
    n = keys.shape[0]
    s, p = fn(keys_dev)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(
        np.asarray(s)[:n], keys[order], err_msg=f"{method} keys n={n}"
    )
    np.testing.assert_array_equal(
        np.asarray(p)[:n], order, err_msg=f"{method} permutation n={n}"
    )


def bench_sorts(rng) -> dict[int, dict[str, float]]:
    results: dict[int, dict[str, float]] = {}
    for n in SIZES:
        keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
        keys_dev = jnp.asarray(keys)
        results[n] = {}
        for method in METHODS:
            fn = pair_sort(method)
            if method == "xla" and n == HEADLINE_N:
                log(f"[bench] xla pair sort custom calls: "
                    f"{custom_call_targets(fn, keys_dev)}")
            check_pairs(fn, keys_dev, keys, method)
            dt = statistics.median(time_call(fn, keys_dev, reps=REPS[n]))
            results[n][method] = dt
            log(f"[bench] n={n:>9} {method:>5}: {dt * 1e3:9.3f} ms/sort "
                f"({n / dt / 1e6:8.1f} M keys/s)")
    return results


def bench_payload_sort(rng, n: int = HEADLINE_N) -> float:
    keys = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    payload = rng.integers(-(1 << 31), 1 << 31, (n, 16), dtype=np.int32)

    @jax.jit
    def step(k, pay):
        tbl = Table({"key": make_key_column(k), "payload": make_column(pay)})
        out = sort_table(tbl, "key")
        return out["key"].data, out["payload"].data

    args = (jnp.asarray(keys), jnp.asarray(payload))
    sk, sp = step(*args)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk)[:n], keys[order])
    np.testing.assert_array_equal(np.asarray(sp)[:n], payload[order])
    dt = statistics.median(time_call(step, *args, reps=10))
    log(f"[bench] n={n:>9} 64B-row table sort: {dt * 1e3:9.3f} ms "
        f"({n / dt / 1e6:8.1f} M rows/s)")
    return dt


def main() -> int:
    require_gpu()
    enable_compile_cache()
    summary = device_summary()
    log(f"[bench] devices={jax.devices()}")
    for line in card_name_and_power_limit():
        print(line, flush=True)
    rng = np.random.default_rng(20170101)

    results = bench_sorts(rng)
    bench_payload_sort(rng)

    for n, by_method in results.items():
        log(f"[bench] n={n}: fastest={min(by_method, key=by_method.get)}")
    headline = results[HEADLINE_N]
    best = min(headline, key=headline.get)
    value = HEADLINE_N / headline[best]
    print(
        json.dumps(
            {
                "metric": (
                    "uint32 keys/s, stable 1,048,576 key+index sort, one "
                    f"device (best method: {best})"
                ),
                "value": round(value),
                "unit": "keys/s",
                "vs_baseline": round(value / BASELINE_KEYS_PER_S, 3),
                "device": summary,
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
