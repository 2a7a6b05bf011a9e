"""Sharded one-pass MSD build (parallel/bigsort.py) vs the oracle."""

import numpy as np
import pytest

from hpc_suffix_array_tpu.core.oracle import suffix_array_oracle
from hpc_suffix_array_tpu.parallel import make_mesh
from hpc_suffix_array_tpu.parallel.bigsort import build_suffix_array_sharded_big

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    dtype=np.uint8)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(8)


def _check(text, mesh, **kw):
    sa = np.asarray(build_suffix_array_sharded_big(text, mesh, **kw))
    ref = suffix_array_oracle(text.tobytes())
    assert np.array_equal(sa, ref)


def test_random_alnum(mesh8, rng):
    _check(ALNUM[rng.integers(0, 62, 8 * 4096)], mesh8)


def test_random_bytes(mesh8, rng):
    _check(rng.integers(0, 256, 3 * 4096).astype(np.uint8), mesh8)


def test_dna(mesh8, rng):
    _check(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 8 * 2048)],
           mesh8)


def test_periodic_chain(mesh8, rng):
    base = ALNUM[rng.integers(0, 62, 1000)]
    text = np.tile(base, 40)[: 8 * 4096]
    _check(text, mesh8)


def test_all_same_char(mesh8):
    _check(np.full(8 * 1024, ord("a"), np.uint8), mesh8)


def test_short_period(mesh8):
    _check(np.frombuffer(b"ab" * (4 * 1024), np.uint8), mesh8)


def test_residue_patch(mesh8, rng):
    """A text with a few long duplicated windows: ascending mode with
    host-resolved residue groups (ties beyond 2*spw symbols)."""
    text = ALNUM[rng.integers(0, 62, 8 * 2048)].copy()
    text[500:600] = text[3000:3100]       # one 100-byte repeat
    text[7000:7040] = text[9000:9040]     # one 40-byte repeat
    _check(text, mesh8)


def test_irregular_heavy_ties_fall_back(mesh8, rng):
    """Mostly-periodic text with a corrupted tail: chain mode must refuse
    (delta not a global period / irregular chains) rather than return a
    wrong SA — the caller then uses the doubling builder."""
    base = ALNUM[rng.integers(0, 62, 8)]
    text = np.tile(base, 2048)[: 8 * 2048].copy()
    text[-100:] = ALNUM[rng.integers(0, 62, 100)]
    try:
        _check(text, mesh8)          # correct is also acceptable
    except NotImplementedError:
        pass


def test_sharded_build_routes_to_msd(mesh8, rng, monkeypatch):
    """build_suffix_array_sharded routes large texts through the one-pass
    builder (and the result stays exact), falling back on refusal."""
    from hpc_suffix_array_tpu.parallel import build_suffix_array_sharded

    monkeypatch.setenv("SA_SHARDED_MSD_MIN", "4096")
    text = ALNUM[rng.integers(0, 62, 8 * 2048)]
    sa = np.asarray(build_suffix_array_sharded(text, mesh8))
    assert np.array_equal(sa, suffix_array_oracle(text.tobytes()))
    # corrupted-tail periodic text: MSD may refuse -> doubling fallback
    base = ALNUM[rng.integers(0, 62, 8)]
    tricky = np.tile(base, 2048)[: 8 * 2048].copy()
    tricky[-100:] = ALNUM[rng.integers(0, 62, 100)]
    sa = np.asarray(build_suffix_array_sharded(tricky, mesh8))
    assert np.array_equal(sa, suffix_array_oracle(tricky.tobytes()))


def test_mesh_shape_invariance(rng):
    text = ALNUM[rng.integers(0, 62, 8 * 1024)]
    ref = suffix_array_oracle(text.tobytes())
    for p in (1, 2, 4, 8):
        sa = np.asarray(build_suffix_array_sharded_big(text, make_mesh(p)))
        assert np.array_equal(sa, ref), f"mesh={p}"


# --- wide-index (two-word global index) mode: the >=4 GiB path ---------

def test_wide_random_alnum(mesh8, rng):
    _check(ALNUM[rng.integers(0, 62, 8 * 4096)], mesh8, wide_index=True)


def test_wide_random_bytes(mesh8, rng):
    _check(rng.integers(0, 256, 3 * 4096).astype(np.uint8), mesh8,
           wide_index=True)


def test_wide_periodic_chain(mesh8, rng):
    _check(np.tile(ALNUM[rng.integers(0, 62, 500)], 60), mesh8,
           wide_index=True)


def test_wide_all_same_char(mesh8):
    _check(np.full(8 * 1024, ord("a"), np.uint8), mesh8, wide_index=True)


def test_wide_residue_patch(mesh8, rng):
    text = ALNUM[rng.integers(0, 62, 8 * 2048)]
    block = ALNUM[rng.integers(0, 62, 64)]
    for at in (100, 5000, 9000, 13000):
        text[at:at + 64] = block
    _check(text, mesh8, wide_index=True)


def test_wide_matches_narrow(mesh8, rng):
    """Same input, both index widths: identical arrays (dtype aside)."""
    text = ALNUM[rng.integers(0, 62, 8 * 2048)]
    wide = np.asarray(build_suffix_array_sharded_big(
        text, mesh8, wide_index=True))
    narrow = np.asarray(build_suffix_array_sharded_big(
        text, mesh8, wide_index=False))
    assert wide.dtype == np.int64
    assert np.array_equal(wide, narrow.astype(np.int64))


def _check_lcp(text, mesh, **kw):
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    sa, lcp = build_suffix_array_sharded_big(text, mesh, want_lcp=True,
                                             **kw)
    ref = np.asarray(suffix_array_oracle(text.tobytes()))
    assert np.array_equal(np.asarray(sa), ref)
    assert np.array_equal(np.asarray(lcp), lcp_oracle(text, ref))


def test_want_lcp_random(mesh8, rng):
    _check_lcp(ALNUM[rng.integers(0, 62, 8 * 4096)], mesh8)


def test_want_lcp_bytes(mesh8, rng):
    _check_lcp(rng.integers(0, 256, 3 * 4096).astype(np.uint8), mesh8)


def test_want_lcp_periodic_chain(mesh8, rng):
    base = ALNUM[rng.integers(0, 62, 500)]
    _check_lcp(np.tile(base, 70)[:8 * 4096], mesh8)


def test_want_lcp_residue(mesh8, rng):
    """Ties past the carried window take the host lcp patches."""
    text = ALNUM[rng.integers(0, 62, 8 * 4096)]
    block = ALNUM[rng.integers(0, 62, 80)]
    for at in (700, 9000, 17000, 25000):
        text[at:at + 80] = block
    _check_lcp(text, mesh8)


def test_want_lcp_wide_host(mesh8, rng):
    """Forced wide-index build WITH LCP (two-word base-m lcp columns,
    host-materialized) matches the oracles — closes r2's
    NotImplementedError (VERDICT missing #2)."""
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    text = ALNUM[rng.integers(0, 62, 8 * 2048)]
    sa, lcp = build_suffix_array_sharded_big(
        text, mesh8, wide_index=True, want_lcp=True)
    want = np.asarray(suffix_array_oracle(text.tobytes())).astype(np.int64)
    assert np.array_equal(sa, want)
    assert np.array_equal(lcp, np.asarray(lcp_oracle(text, want)))


def test_want_lcp_wide_device_columns(mesh8, rng):
    """device_columns=True keeps the (hi, lo) pairs sharded on device
    (residue patched per shard in-kernel); recombining equals the host
    materialization and the oracles."""
    import jax
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    text = ALNUM[rng.integers(0, 62, 8 * 2048)]
    (sa_hi, sa_lo), (lcp_hi, lcp_lo) = build_suffix_array_sharded_big(
        text, mesh8, wide_index=True, want_lcp=True, device_columns=True)
    n = len(text)
    n_pad = sa_hi.shape[0]
    m = n_pad // 8
    assert len(sa_hi.sharding.device_set) == 8      # stayed sharded
    sa = (np.asarray(jax.device_get(sa_hi)).astype(np.int64) * m
          + np.asarray(jax.device_get(sa_lo)))[:n]
    lcp = (np.asarray(jax.device_get(lcp_hi)).astype(np.int64) * m
           + np.asarray(jax.device_get(lcp_lo)))[:n]
    want = np.asarray(suffix_array_oracle(text.tobytes())).astype(np.int64)
    assert np.array_equal(sa, want)
    assert np.array_equal(lcp, np.asarray(lcp_oracle(text, want)))


def test_wide_periodic_chain_lcp(mesh8, rng):
    """Wide + periodic: chain-rule lcp = n - prev_g via two-word borrow
    arithmetic, exact vs the Kasai oracle."""
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    base = ALNUM[rng.integers(0, 62, 97)]
    text = np.tile(base, (8 * 2048) // 97 + 1)[:8 * 2048]
    sa, lcp = build_suffix_array_sharded_big(
        text, mesh8, wide_index=True, want_lcp=True)
    want = np.asarray(suffix_array_oracle(text.tobytes())).astype(np.int64)
    assert np.array_equal(sa, want)
    assert np.array_equal(lcp, np.asarray(lcp_oracle(text, want)))


def test_sharded_dna_third_word(mesh8, rng, monkeypatch):
    """Small-alphabet texts whose 2-word residue overflows the mesh cap
    ride the carried-keys path with nw=3 instead of falling back to
    doubling (VERDICT r3 #2). Force the gate (a genuinely overflowing
    text needs n >= 2^26) and verify the 3-word sharded kernel is exact,
    narrow and wide, with LCP."""
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle
    import hpc_suffix_array_tpu.parallel.bigsort as pb

    real = pb.residue_feasible
    monkeypatch.setattr(
        pb, "residue_feasible",
        lambda arr, n, cap, est=None, words=2, spw=None: words >= 3)
    dna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 8 * 2048)]
    want = np.asarray(suffix_array_oracle(dna.tobytes()))
    sa, lcp = build_suffix_array_sharded_big(dna, mesh8, want_lcp=True)
    assert np.array_equal(np.asarray(sa), want)
    assert np.array_equal(np.asarray(lcp), np.asarray(lcp_oracle(dna, want)))
    sa_w, lcp_w = build_suffix_array_sharded_big(
        dna, mesh8, wide_index=True, want_lcp=True)
    assert np.array_equal(sa_w, want.astype(np.int64))
    assert np.array_equal(lcp_w, np.asarray(lcp_oracle(dna, want)))
    # sanity: with the real gate this corpus would have chosen 2 words
    assert real(dna, len(dna), 8 * (1 << 15) / 4)


def test_wide_device_columns_with_residue(mesh8, rng):
    """device_columns wide build on a text with genuine window-tied
    groups: the per-shard patch kernel (_patch_kernel + _group_patches)
    must land every host-resolved value, including a group at global
    slot 0 (the duplicate-scatter hazard class fixed in r3)."""
    import jax
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    n = 8 * 2048
    text = ALNUM[rng.integers(0, 62, n)]
    block = ALNUM[rng.integers(0, 62, 60)]
    for at in (1000, 4000, 9000, 13000):   # deep repeats -> host residue
        text[at:at + 60] = block
    # force the smallest suffixes to tie through the carried window
    text[:40] = ord("!")
    text[8000:8040] = ord("!")
    (s_hi, s_lo), (l_hi, l_lo) = build_suffix_array_sharded_big(
        text, mesh8, wide_index=True, want_lcp=True, device_columns=True)
    m = s_hi.shape[0] // 8
    sa = (np.asarray(jax.device_get(s_hi)).astype(np.int64) * m
          + np.asarray(jax.device_get(s_lo)))[:n]
    lcp = (np.asarray(jax.device_get(l_hi)).astype(np.int64) * m
           + np.asarray(jax.device_get(l_lo)))[:n]
    want = np.asarray(suffix_array_oracle(text.tobytes())).astype(np.int64)
    assert np.array_equal(sa, want)
    assert np.array_equal(lcp, np.asarray(lcp_oracle(text, want)))


def test_minpad_dna_lcp_min_tail(mesh8, rng):
    """DNA rides min-pad packing (2-bit codes, 30 carried symbols) in
    the sharded kernels; a minimum-symbol tail run forces pad-induced
    window ties AND the final shorter-suffix-length clamp (narrow
    _clamp_lcp and the wide two-word _clamp_kernel_wide)."""
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    dna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 8 * 2048)]
    dna[-40:] = ord("A")
    want = np.asarray(suffix_array_oracle(dna.tobytes()))
    want_l = np.asarray(lcp_oracle(dna, want))
    sa, lcp = build_suffix_array_sharded_big(dna, mesh8, want_lcp=True)
    assert np.array_equal(np.asarray(sa), want)
    assert np.array_equal(np.asarray(lcp), want_l)
    # Wide host mode (numpy clamp path).
    sa, lcp = build_suffix_array_sharded_big(
        dna, mesh8, wide_index=True, want_lcp=True)
    assert np.array_equal(sa, want)
    assert np.array_equal(lcp, want_l)
    # Wide device-columns mode (two-word clamp kernel).
    import jax

    n = len(dna)
    (sh, sl), (lh, ll) = build_suffix_array_sharded_big(
        dna, mesh8, wide_index=True, want_lcp=True, device_columns=True)
    m = sh.shape[0] // 8
    sa_d = (np.asarray(jax.device_get(sh)).astype(np.int64) * m
            + np.asarray(jax.device_get(sl)))[:n]
    lcp_d = (np.asarray(jax.device_get(lh)).astype(np.int64) * m
             + np.asarray(jax.device_get(ll)))[:n]
    assert np.array_equal(sa_d, want)
    assert np.array_equal(lcp_d, want_l)


def test_minpad_dna_stays_two_words(mesh8, rng):
    """Under min-pad packing DNA's 2-word window is 30 symbols — the
    third carried word must no longer be selected at any feasible n."""
    import hpc_suffix_array_tpu.parallel.bigsort as pb

    seen = {}
    orig = pb._kernels

    def spy(mesh, bits, spw, ranges, nw=2, minpad=False):
        seen.update(bits=bits, spw=spw, nw=nw, minpad=minpad)
        return orig(mesh, bits, spw, ranges, nw, minpad)

    pb_kernels, pb._kernels = pb._kernels, spy
    try:
        dna = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                            8 * 1024)]
        _check(dna, mesh8)
    finally:
        pb._kernels = pb_kernels
    assert seen == dict(bits=2, spw=15, nw=2, minpad=True)


def test_minpad_binary_periodic_chain(mesh8):
    """Binary periodic text: 1-bit min-pad codes + chain mode + the
    narrow clamp on the chain return path."""
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    text = np.tile(np.frombuffer(b"0110100110010110", np.uint8), 1024)
    want = np.asarray(suffix_array_oracle(text.tobytes()))
    sa, lcp = build_suffix_array_sharded_big(text, mesh8, want_lcp=True)
    assert np.array_equal(np.asarray(sa), want)
    assert np.array_equal(np.asarray(lcp), np.asarray(lcp_oracle(text,
                                                                 want)))


# --- multi-process entry (_DistText): no process holds the full text ---
#
# Single-process instances of the mp API (process_count == 1, the full
# padded text IS the local block) drive the same device-side components
# the real 2-process test (tests/test_multihost.py) exercises across a
# process boundary: histogram-psum alphabet, allgathered repeat
# estimate, ring-rotation period check, window-gather residue
# resolution. Outputs are PADDED sharded arrays (rows [0, n) valid).

def _mp_build(text, mesh, **kw):
    from hpc_suffix_array_tpu.parallel.bigsort import (
        build_suffix_array_sharded_big_mp, mp_local_geometry)

    n = len(text)
    n_pad, start, stop = mp_local_geometry(n, mesh)
    assert (start, stop) == (0, n_pad)        # single process owns all
    block = np.zeros(n_pad, np.uint8)
    block[:n] = text
    return build_suffix_array_sharded_big_mp(block, n, mesh, **kw)


def _check_mp(text, mesh, **kw):
    sa_pad = _mp_build(text, mesh, **kw)
    n = len(text)
    sa = np.asarray(sa_pad)
    assert np.all(sa[n:] == n)                # pad rows hold n
    assert np.array_equal(sa[:n], suffix_array_oracle(text.tobytes()))


def test_mp_random_alnum(mesh8, rng):
    _check_mp(ALNUM[rng.integers(0, 62, 8 * 4096)], mesh8)


def test_mp_dna_minpad(mesh8, rng):
    _check_mp(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4,
                                                            8 * 2048)],
              mesh8)


def test_mp_periodic_chain(mesh8, rng):
    """Globally periodic text: the device-side period check (ring
    rotations + halo, _period_kernel) must ACCEPT the chain."""
    base = ALNUM[rng.integers(0, 62, 1000)]
    _check_mp(np.tile(base, 40)[: 8 * 4096], mesh8)


def test_mp_chain_misprediction_retries(mesh8, rng):
    """A long repeated block without a global period: the local repeat
    estimate predicts chain mode, the device period check must REFUSE
    the delta, and the ascending retry + window-gather residue must
    still produce the exact SA."""
    text = ALNUM[rng.integers(0, 62, 8 * 4096)]
    text[2000:2100] = text[20000:20100]       # 100-byte repeat (> 64)
    _check_mp(text, mesh8)


def test_mp_residue_deep_windows(mesh8, rng):
    """Tied groups deeper than RESIDUE_WIN exercise _GatheredView's
    prefetch + deep-window compare (suffix_less / suffix_lcp), and the
    LCP patches land exactly."""
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    text = ALNUM[rng.integers(0, 62, 8 * 4096)]
    block = ALNUM[rng.integers(0, 62, 200)]
    for at in (500, 9000, 17000):             # 200-byte triple repeat
        text[at:at + 200] = block
    n = len(text)
    sa_pad, lcp_pad = _mp_build(text, mesh8, want_lcp=True)
    want = np.asarray(suffix_array_oracle(text.tobytes()))
    assert np.array_equal(np.asarray(sa_pad)[:n], want)
    assert np.array_equal(np.asarray(lcp_pad)[:n],
                          np.asarray(lcp_oracle(text, want)))


def test_mp_tie_past_deep_window_falls_back(mesh8, rng):
    """Suffix pairs tied past the 4096-byte gather window cannot be
    resolved without whole-text access: the mp build must raise
    NotImplementedError (doubling fallback), never return a wrong SA."""
    text = ALNUM[rng.integers(0, 62, 8 * 4096)]
    text[64:64 + 6000] = text[16384:16384 + 6000]   # 6000-byte repeat
    with pytest.raises(NotImplementedError):
        _mp_build(text, mesh8)


def test_mp_wide_device_columns_lcp(mesh8, rng):
    """Forced wide mp build: two-word device columns with LCP, residue
    patched per shard, vs the oracles."""
    import jax
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    text = ALNUM[rng.integers(0, 62, 8 * 2048)]
    block = ALNUM[rng.integers(0, 62, 80)]
    for at in (700, 9000):
        text[at:at + 80] = block
    n = len(text)
    (s_hi, s_lo), (l_hi, l_lo) = _mp_build(text, mesh8, wide_index=True,
                                           want_lcp=True)
    m = s_hi.shape[0] // 8
    sa = (np.asarray(jax.device_get(s_hi)).astype(np.int64) * m
          + np.asarray(jax.device_get(s_lo)))[:n]
    lcp = (np.asarray(jax.device_get(l_hi)).astype(np.int64) * m
           + np.asarray(jax.device_get(l_lo)))[:n]
    want = np.asarray(suffix_array_oracle(text.tobytes())).astype(np.int64)
    assert np.array_equal(sa, want)
    assert np.array_equal(lcp, np.asarray(lcp_oracle(text, want)))


def test_mp_matches_host_api(mesh8, rng):
    """The mp entry and the single-process entry agree bit-for-bit on
    the same input (same kernels, different text-access strategy)."""
    text = ALNUM[rng.integers(0, 62, 8 * 2048)]
    text[100:164] = text[5000:5064]
    n = len(text)
    via_mp = np.asarray(_mp_build(text, mesh8))[:n]
    via_host = np.asarray(build_suffix_array_sharded_big(text, mesh8))
    assert np.array_equal(via_mp, via_host)


def test_wide_auto_enable_boundary():
    """The auto-enable predicate fires exactly where a padded index
    could leave int32 (r5; executed at 2^29 on the CPU mesh)."""
    from hpc_suffix_array_tpu.parallel.bigsort import wide_auto

    assert not wide_auto((1 << 31) - 2)
    assert wide_auto((1 << 31) - 1)
    assert wide_auto(1 << 31)
    assert wide_auto((1 << 31) + (1 << 28))
