"""Test configuration: an 8-device virtual CPU mesh, or the real GPU.

By default every test runs on the CPU with XLA's forced host device
count - the analog of the reference's ``mpirun --oversubscribe``
single-node fakery (reference scripts/benchmark_mpi.py:61). Must run
before jax's backends start.

``SA_TEST_PLATFORM=gpu`` leaves the platform to JAX, for the tests
marked ``gpu`` (``pytest -m gpu``); those skip through the ``gpu``
fixture wherever the default device is not a GPU.
"""

import os
import re as _re

GPU_RUN = os.environ.get("SA_TEST_PLATFORM") == "gpu"

import jax  # noqa: E402

if not GPU_RUN:
    # Replace any pre-set device count rather than only appending: a
    # different count would otherwise abort collection. jax.config is the
    # reliable override even where jax was imported before this file.
    flags = os.environ.get("XLA_FLAGS", "")
    flags = _re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                    flags)
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
    jax.config.update("jax_platforms", "cpu")
    # No persistent compile cache on the CPU: XLA:CPU entries are tied
    # to the build host's machine features.
    if jax.local_device_count() != 8:
        import pytest as _pytest

        _pytest.exit(
            "tests require the 8-device virtual CPU mesh (jax was "
            "initialized before conftest could set XLA_FLAGS); got "
            f"{jax.devices()}", returncode=3)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from hpc_suffix_array_tpu.utils.hostmem import (  # noqa: E402
    disable_hugepage_madvise, keep_host_memory_hot)

disable_hugepage_madvise()   # VM-class host-memory workarounds
keep_host_memory_hot()       # (see utils/hostmem.py)


@pytest.fixture
def gpu():
    """The default device, or a skip when it is not an NVIDIA GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (make test-gpu)")
    return dev


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)


# Canonical fixture strings; goldens from the reference Makefile:131-138 and
# generate_large_datasets.py:86-102.
CANONICAL = {
    "banana": b"banana",
    "mississippi": b"mississippi",
    "abcabcabc": b"abcabcabc",
    "aaaa": b"a" * 1000,
    "ababab": b"ab" * 500,
}

GOLDEN_LRS = {
    "banana": b"ana",
    "mississippi": b"issi",
    "abcabcabc": b"abcabc",
    "aaaa": b"a" * 999,
    "ababab": b"ab" * 499,
}


@pytest.fixture(params=sorted(CANONICAL))
def canonical_case(request):
    return request.param, CANONICAL[request.param]
