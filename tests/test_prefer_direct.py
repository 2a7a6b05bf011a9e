"""Routing-preference gate (core/bigsort.prefer_direct) semantics.

Pins the r4 crossover contract without touching a device: direct is
preferred up to SA_DIRECT_CROSS, the fine-geometry MSD above it for
non-chain text, and chain-class (globally periodic) texts stay direct
up to the feasibility cap (the prefer_direct docstring says where
the crossover came from).
"""

import numpy as np
import pytest

from hpc_suffix_array_tpu.core.bigsort import prefer_direct

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    np.uint8)


def _random_text(n: int) -> np.ndarray:
    return ALNUM[np.random.default_rng(0).integers(0, 62, n)]


def _periodic_text(n: int, period: int = 1000) -> np.ndarray:
    pat = ALNUM[np.random.default_rng(1).integers(0, 62, period)]
    return np.tile(pat, n // period + 1)[:n]


@pytest.fixture
def knobs(monkeypatch):
    # Shrunken thresholds so the gate is exercised at test sizes.
    monkeypatch.setenv("SA_DIRECT_CROSS", str(1 << 14))
    monkeypatch.setenv("SA_DIRECT_MAX", str(1 << 16))
    return None


def test_direct_below_cross(knobs):
    t = _random_text(1 << 13)
    assert prefer_direct(t, len(t))


def test_msd_above_cross_random(knobs):
    # Random text above the crossover: the fine-geometry MSD wins
    # (195.6 vs 192.8 MB/s at 2^28, r4) — prefer_direct says no.
    t = _random_text(3 << 14)
    assert not prefer_direct(t, len(t))


def test_chain_stays_direct_above_cross(knobs):
    # Globally periodic text above the crossover: direct chain beats
    # the MSD chain pass (179.8 vs 110.1 at 2^28, r4).
    t = _periodic_text(3 << 14)
    assert prefer_direct(t, len(t))


def test_infeasible_above_max(knobs):
    # Above the feasibility cap nothing is preferred — the caller goes
    # straight to the MSD.
    t = _random_text(1 << 17)
    assert not prefer_direct(t, len(t))
    assert not prefer_direct(_periodic_text(1 << 17), 1 << 17)


def test_est_repeat_hint_respected(knobs):
    # A caller-supplied est_repeat skips the sampling pass and decides
    # chain-class directly. Chain-class means the estimate saturates
    # near the 4096-byte probe depth (globally periodic texts always
    # do — chain_plausible); a merely long repeat (e.g. a word corpus's
    # repeated phrase) is NOT chain-class and follows the measured
    # random-text crossover to the MSD (r5).
    t = _random_text(3 << 14)
    assert prefer_direct(t, len(t), est_repeat=4000)
    assert not prefer_direct(t, len(t), est_repeat=1000)
    assert not prefer_direct(t, len(t), est_repeat=4)


def test_precomputed_products_match_recomputed(knobs):
    # The r4 planning-dedup contract: passing sigma/est_repeat through
    # the gates and remap/est_repeat into the prepares must be
    # equivalent to letting each step re-scan the text (the routers
    # thread one scan through — core/suffix_array, core/lcp, cli).
    from hpc_suffix_array_tpu.core.bigsort import (
        direct_feasible, estimate_repeat_len, prepare_direct,
        residue_feasible)
    from hpc_suffix_array_tpu.core.suffix_array import alphabet_remap

    for t in (_random_text(1 << 13), _periodic_text(1 << 13)):
        n = len(t)
        remap, _, _ = alphabet_remap(t)
        sigma = int(remap.max())
        est = estimate_repeat_len(t)
        assert prefer_direct(t, n) == prefer_direct(
            t, n, est_repeat=est, sigma=sigma)
        assert direct_feasible(t, n) == direct_feasible(
            t, n, est, sigma=sigma)
        for words in (2, 3):
            assert residue_feasible(t, n, 64.0, words=words) == \
                residue_feasible(t, n, 64.0, est, words=words, sigma=sigma)
        a = prepare_direct(t)
        b = prepare_direct(t, remap=remap, est_repeat=est)
        assert (a["n"], a["n_pad"], a["bits"], a["spw"], a["nw"],
                a["minpad"], a["meta"]["est_repeat"]) == \
               (b["n"], b["n_pad"], b["bits"], b["spw"], b["nw"],
                b["minpad"], b["meta"]["est_repeat"])
