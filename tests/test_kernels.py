"""Doubling-path kernels on the CPU: the packing fold and the rank route."""

import numpy as np
import jax.numpy as jnp
import pytest

from hpc_suffix_array_tpu.core.suffix_array import pack_ranks_kernel
from hpc_suffix_array_tpu.ops.scan import route_to_positions


def _reference_pack(codes, bits, h0):
    ext = np.concatenate([codes, np.zeros(h0, np.int32)])
    want = np.zeros(len(codes), np.int64)
    for j in range(h0):
        want = (want << bits) | ext[j:j + len(codes)]
    return want.astype(np.int32)


def _pack(rng, n, bits, h0, n_real):
    """pack_ranks_kernel on random bytes whose codes use all ``bits``
    bits; returns (got, codes with the pad region zeroed)."""
    text = np.zeros(n, np.uint8)
    text[:n_real] = rng.integers(0, 256, n_real)
    remap = rng.integers(0, 1 << bits, 256).astype(np.int32)
    got = np.asarray(pack_ranks_kernel(
        jnp.asarray(text), jnp.asarray(remap), bits, h0, jnp.int32(n_real)))
    codes = remap[text]
    codes[n_real:] = 0
    return got, codes


@pytest.mark.parametrize("n,bits,h0", [
    (128, 6, 5), (128 * 8, 3, 10), (128 * 9, 9, 3),
    (128 * 513, 6, 5), (1 << 17, 1, 30), (1000, 4, 7),
])
def test_pack_matches_reference(rng, n, bits, h0):
    """The XLA fold equals the numpy fold, with a pad tail past n_real
    and with n_pad not a multiple of 128."""
    got, codes = _pack(rng, n, bits, h0, n - 37)
    assert np.array_equal(got, _reference_pack(codes, bits, h0))


def test_pack_zero_tail(rng):
    """Trailing zeros (pad sentinel region) fold in as rank 0."""
    got, codes = _pack(rng, 1024, 2, 15, 100)
    assert np.array_equal(got, _reference_pack(codes, 2, 15))
    assert not got[100:].any()


@pytest.mark.parametrize("n", [1 << 10, 100_003])
def test_route_to_positions_inverts_sort(rng, n):
    """Routing dense ranks 0..n-1 back through the sort order yields the
    inverse permutation of the order, i.e. np.argsort of it."""
    order = np.argsort(rng.integers(0, 1 << 30, n), kind="stable")
    got = np.asarray(route_to_positions(
        jnp.asarray(order, jnp.int32), jnp.arange(n, dtype=jnp.int32)))
    assert np.array_equal(got, np.argsort(order))
