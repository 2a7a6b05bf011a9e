"""Runtime plumbing: compile cache, platform labels, GPU checks, spawn env."""

import pathlib
import sys

import jax
import pytest

from hpc_suffix_array_tpu.cli_distributed import worker_env
from hpc_suffix_array_tpu.utils.runtime import (
    CHECKOUT, compile_cache_dir, enable_compile_cache, platform_label)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    return chip_smoke


def test_compile_cache_dir_from_env():
    assert compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) == "/x/cache"


def test_compile_cache_dir_default_is_checkout():
    assert CHECKOUT == REPO
    assert compile_cache_dir({}) == str(REPO / ".jax_cache")


def test_compile_cache_off_on_cpu():
    assert enable_compile_cache() is None


def test_platform_label_names_real_platform():
    assert platform_label() == "cpu"
    assert platform_label(4) == "cpu_sharded_4"


def test_smoke_refuses_cpu_device():
    smoke = _chip_smoke()
    with pytest.raises(smoke.SmokeError, match="no GPU"):
        smoke.require_gpu(jax.devices())


def test_spawn_worker_gets_one_card():
    env = worker_env(2, {"PATH": "/bin"})
    assert env["CUDA_VISIBLE_DEVICES"] == "2"
    assert "SA_PLATFORM" not in env


def test_spawn_worker_cpu_only_when_asked():
    env = worker_env(1, {"SA_PLATFORM": "cpu"})
    assert env["SA_PLATFORM"] == "cpu"
    assert "CUDA_VISIBLE_DEVICES" not in env
