"""Sorted-fetch LCP path (core/lcp_window.build_lcp_array_sorted) vs the
Kasai oracle — same corpus family as the gather-window tests, plus the
degenerate alphabets the adaptive word packing must handle."""

import numpy as np
import pytest

from hpc_suffix_array_tpu.core.lcp_window import build_lcp_array_sorted
from hpc_suffix_array_tpu.core.oracle import lcp_oracle, suffix_array_oracle

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)


def _check(text):
    text = np.asarray(text)
    sa = np.asarray(suffix_array_oracle(text.tobytes()))
    lcp = np.asarray(build_lcp_array_sorted(text, sa))
    assert np.array_equal(lcp, np.asarray(lcp_oracle(text, sa)))


def test_random_bytes(rng):
    _check(rng.integers(0, 256, 50_000).astype(np.uint8))


def test_alnum(rng):
    _check(ALNUM[rng.integers(0, 62, 50_000)])


def test_dna(rng):
    _check(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 50_000)])


def test_binary(rng):
    _check(np.frombuffer(b"ab", np.uint8)[rng.integers(0, 2, 20_000)])


def test_long_repeats_host_finish(rng):
    """Scattered 200-byte repeated blocks: misses beyond the packed
    words resolve via the shared host-finish path."""
    text = ALNUM[rng.integers(0, 62, 40_000)]
    block = ALNUM[rng.integers(0, 62, 200)]
    for at in (100, 9000, 25000):
        text[at:at + 200] = block
    _check(text)


def test_periodic_chain_fix(rng):
    _check(np.tile(ALNUM[rng.integers(0, 62, 1000)], 40))


def test_period_two():
    _check(np.tile(np.frombuffer(b"ab", np.uint8), 10_000))


def test_all_same():
    _check(np.full(8192, ord("a"), np.uint8))


def test_tiny_texts():
    for s in (b"banana", b"mississippi", b"abcabcabc", b"a", b"ab"):
        _check(np.frombuffer(s, np.uint8))


def test_routing_default_is_sorted(rng, monkeypatch):
    """build_lcp_array routes big texts through the sorted path by
    default (SA_LCP_FETCH=window selects the gather-window path)."""
    from hpc_suffix_array_tpu.core.lcp import build_lcp_array

    monkeypatch.setenv("SA_LCP_WINDOW_MIN", "10000")
    monkeypatch.delenv("SA_LCP_FETCH", raising=False)
    text = rng.integers(0, 256, 30_000).astype(np.uint8)
    sa = np.asarray(suffix_array_oracle(text.tobytes()))
    lcp = np.asarray(build_lcp_array(text, sa))
    assert np.array_equal(lcp, np.asarray(lcp_oracle(text, sa)))


def test_staged_state_reuse(rng):
    """prepare_lcp_sorted state serves repeated builds (bench form)."""
    from hpc_suffix_array_tpu.core.lcp_window import prepare_lcp_sorted

    text = ALNUM[rng.integers(0, 62, 30_000)]
    sa = np.asarray(suffix_array_oracle(text.tobytes()))
    state = prepare_lcp_sorted(text)
    a = np.asarray(build_lcp_array_sorted(text, sa, state))
    b = np.asarray(build_lcp_array_sorted(text, sa, state))
    assert np.array_equal(a, b)
    assert np.array_equal(a, np.asarray(lcp_oracle(text, sa)))


def test_repetitive_midsize_routes_to_carried_keys(rng, monkeypatch):
    """Deep-repeat texts below the window/big thresholds skip the PLCP
    round loop (many scan-class rounds on repetitive text) and take the
    carried-keys rebuild instead — exact, and the supplied sa is
    cross-checked."""
    import hpc_suffix_array_tpu.core.lcp as L

    called = []
    orig = L._sa_lcp_big

    def spy(text, n, text_dev=None):
        called.append(n)
        return orig(text, n, text_dev=text_dev)

    monkeypatch.setattr(L, "_sa_lcp_big", spy)
    n = 1 << 17                       # 128 KiB < SA_LCP_WINDOW_MIN
    text = np.tile(ALNUM[rng.integers(0, 62, 1000)], n // 1000 + 1)[:n]
    sa = np.asarray(suffix_array_oracle(text.tobytes()))
    lcp = np.asarray(L.build_lcp_array(text, sa))
    assert called == [n]              # the new route actually ran
    assert np.array_equal(lcp, np.asarray(lcp_oracle(text, sa)))
    # Wrong (but valid-permutation) sa must raise, not be ignored.
    bad = sa.copy()
    bad[0], bad[1] = bad[1], bad[0]
    with pytest.raises(ValueError, match="repetitive-text"):
        L.build_lcp_array(text, bad)


def test_random_midsize_stays_on_plcp(rng, monkeypatch):
    """Shallow-repeat texts below the thresholds keep the 1-round PLCP
    path (no carried-keys rebuild dispatched)."""
    import hpc_suffix_array_tpu.core.lcp as L

    def boom(text, n, text_dev=None):
        raise AssertionError("carried-keys route taken for random text")

    monkeypatch.setattr(L, "_sa_lcp_big", boom)
    text = ALNUM[rng.integers(0, 62, 1 << 17)]
    sa = np.asarray(suffix_array_oracle(text.tobytes()))
    lcp = np.asarray(L.build_lcp_array(text, sa))
    assert np.array_equal(lcp, np.asarray(lcp_oracle(text, sa)))


def test_text_dev_sliced_not_restaged(rng, monkeypatch):
    """A caller-supplied text_dev whose FIRST n bytes match the text is
    sliced and used directly by the window routes (the r4 contract that
    keeps bench staging out of the timed region) — bytes past n must
    never influence the result."""
    import jax.numpy as jnp

    from hpc_suffix_array_tpu.core.lcp import build_lcp_array
    from hpc_suffix_array_tpu.core.oracle import suffix_array_oracle

    monkeypatch.setenv("SA_LCP_WINDOW_MIN", "10000")
    monkeypatch.setenv("SA_LCP_BIG_MIN", "1000000")
    text = ALNUM[rng.integers(0, 62, 50_000)]
    sa = np.asarray(suffix_array_oracle(text.tobytes()))
    want = np.asarray(build_lcp_array(text, sa))

    # Longer device buffer, garbage past n (NOT zeros: zeros could hide
    # an off-by-one that reads the pad as a real min symbol).
    dev = jnp.asarray(np.concatenate(
        [text, rng.integers(0, 256, 7777).astype(np.uint8)]))
    got = np.asarray(build_lcp_array(text, sa, text_dev=dev))
    assert np.array_equal(got, want)

    # PLCP route (below the window threshold) honors the same contract.
    monkeypatch.setenv("SA_LCP_WINDOW_MIN", str(1 << 22))
    small = text[:5000]
    sa_s = np.asarray(suffix_array_oracle(small.tobytes()))
    want_s = np.asarray(build_lcp_array(small, sa_s))
    dev_s = jnp.asarray(np.concatenate(
        [small, rng.integers(0, 256, 321).astype(np.uint8)]))
    got_s = np.asarray(build_lcp_array(small, sa_s, text_dev=dev_s))
    assert np.array_equal(got_s, want_s)
