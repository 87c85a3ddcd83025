"""Device bring-up shared by ``chip_smoke.py`` and ``bench.py``.

The GPU check (a measurement that finds no GPU fails; it never falls back to
the CPU), the card's identity as every reported number must carry it, the
persistent compile cache, and a wall-clock timer that waits for the device.
"""

from __future__ import annotations

import os
import pathlib
import subprocess
import time
from typing import Callable

import jax

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at one fixed directory.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set, else ``<checkout>/.jax_cache``
    (a fixed path, so a later run from the same checkout hits the cache).
    Returns the directory.
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu(count: int = 1) -> list:
    """The first ``count`` devices; raise unless JAX found that many GPUs."""
    devices = jax.devices()
    if devices[0].platform != "gpu" or len(devices) < count:
        raise RuntimeError(
            f"needs {count} GPU device(s); JAX found {devices}"
        )
    return devices[:count]


def device_summary() -> dict:
    """Platform, device kind and device count as JAX reports them."""
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def card_name_and_power_limit() -> list[str]:
    """One ``name, power.limit`` line per card, as nvidia-smi prints them."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()


def peak_bytes_in_use(device) -> int | None:
    """The device allocator's peak since the process started (None on CPU)."""
    stats = device.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def time_call(fn: Callable, *args, reps: int = 5, warmup: int = 1):
    """Seconds of each of ``reps`` calls of ``fn(*args)``, device included.

    Each call ends in ``jax.block_until_ready``; ``warmup`` calls first take
    compilation out of the timed calls.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times
