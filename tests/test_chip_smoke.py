"""chip_smoke.py: every phase at a tiny size on the CPU, and its GPU guard.

The script itself refuses to run without a GPU; its phase functions take
their sizes as arguments, so the same code that runs at full size on the
card is checked here against the same numpy references.
"""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from gpuradixsort.core.table import Column
from gpuradixsort.parallel.mesh import make_row_mesh

ROOT = pathlib.Path(__file__).resolve().parents[1]

ONE_CARD_SIZES = {
    "reference_sort": {"n": 5000},
    "large_sort": {"n": 20_000},
    "payload_sort": {"n": 3000},
    "filter_sort": {"n": 20_000},
    "group_by": {"n": 20_000, "groups": 500},
    "join": {"n_build": 2000, "n_probe": 20_000},
}

# Four-card sizes are multiples of num_shards * block = 4 * 8192.
FOUR_CARD_SIZES = {
    "dist_sort": {"n": 65_536},
    "dist_group_by": {"n": 65_536, "groups": 1000},
    "dist_join": {"n_build": 32_768, "n_probe": 65_536},
}


def test_phase_tables_cover_sizes():
    assert set(chip_smoke.ONE_CARD_PHASES) == set(ONE_CARD_SIZES)
    assert set(chip_smoke.FOUR_CARD_PHASES) == set(FOUR_CARD_SIZES)


@pytest.mark.parametrize("name", sorted(ONE_CARD_SIZES))
def test_one_card_phase(name):
    info = chip_smoke.ONE_CARD_PHASES[name](
        np.random.default_rng(1), **ONE_CARD_SIZES[name]
    )
    assert info["rows"] > 0
    assert all(v >= 0 for k, v in info.items() if k.endswith("_s"))


@pytest.mark.parametrize("name", sorted(FOUR_CARD_SIZES))
def test_four_card_phase(name):
    info = chip_smoke.FOUR_CARD_PHASES[name](
        np.random.default_rng(2), make_row_mesh(4), **FOUR_CARD_SIZES[name]
    )
    assert info["rows"] > 0


def test_wrong_output_fails_the_phase(monkeypatch):
    # A phase whose entry point returns a wrong answer must raise, never
    # report success: swap in a sort that forgets the last key.
    real = chip_smoke.sort_pairs

    def broken(keys, *args, **kwargs):
        s, p = real(keys, *args, **kwargs)
        return Column(s.data.at[s.length - 1].set(0), s.length), p

    monkeypatch.setattr(chip_smoke, "sort_pairs", broken)
    with pytest.raises(AssertionError, match="keys"):
        chip_smoke.phase_large_sort(np.random.default_rng(3), n=5000)


def test_join_reference_matches_brute_force():
    rng = np.random.default_rng(4)
    bk = chip_smoke._unique_keys(rng, 300)
    assert np.unique(bk).shape[0] == 300
    bv = np.arange(300, dtype=np.int32)
    pk = chip_smoke._probe_keys(rng, bk, 2000)
    pv = np.arange(2000, dtype=np.int32)
    k, opv, obv = chip_smoke._join_reference(pk, pv, bk, bv)
    lookup = dict(zip(bk.tolist(), bv.tolist()))
    want = [(int(a), int(b), lookup[int(a)]) for a, b in zip(pk, pv)
            if int(a) in lookup]
    assert list(zip(k.tolist(), opv.tolist(), obv.tolist())) == want


def test_guard_refuses_cpu(capsys):
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.main([])
    with pytest.raises(RuntimeError, match="GPU"):
        chip_smoke.main(["--chips", "4"])
    assert '"ok"' not in capsys.readouterr().out


def _run_script(cwd: pathlib.Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _has_result_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return True
        except (ValueError, AttributeError):
            continue
    return False


def test_script_exits_nonzero_without_gpu():
    proc = _run_script(ROOT)
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)
    assert "GPU" in proc.stderr


def test_script_exits_nonzero_without_the_engine(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_script(tmp_path)
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)
