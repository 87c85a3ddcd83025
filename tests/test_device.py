"""Device bring-up helpers: compile cache location, device summary, timer."""

import jax
import jax.numpy as jnp
import pytest

from gpuradixsort.utils import device


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert device.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(device.CHECKOUT / ".jax_cache")
    assert device.enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want
    assert (device.CHECKOUT / "gpuradixsort").is_dir()


def test_require_gpu_refuses_cpu():
    with pytest.raises(RuntimeError, match="GPU"):
        device.require_gpu()


def test_device_summary_names_backend():
    summary = device.device_summary()
    assert summary == {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices()),
    }


def test_time_call_waits_and_counts_reps():
    times = device.time_call(lambda x: x * 2, jnp.ones(8), reps=3)
    assert len(times) == 3 and all(t >= 0 for t in times)
