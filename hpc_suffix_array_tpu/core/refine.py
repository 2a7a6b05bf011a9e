"""Unbounded tie resolution on device: iterative window-deepening.

The carried-keys builders (core/bigsort.py) resolve each suffix pair by
its first ``nw*spw`` symbols and leave the still-tied pairs to a BOUNDED
host residue pass (``RESIDUE_SLOTS`` per extraction).  Real index-server
corpora — natural language, source code, logs — have repeated 8-20
symbol windows covering a large fraction of positions, so at 1 GiB the
window-tied mass is far beyond any host cap and, before this module, the
build *refused* (r4 VERDICT missing #1).  The reference builds any text
in O(n log n) (src/sequential/manber_myers.c:81-133); this module makes
the carried-keys paths do the same without giving up their speed:

  1. *Extract* every tied member (final SA slot, text index) into device
     piece arrays — pieces split only at clean cuts (slots whose tie
     flag is 0), so each tie group lives in exactly one piece.
  2. *Refine* each piece by rounds: gather the next ``2*spw`` symbols of
     each row from the (device-resident) text as one packed word pair,
     re-sort rows within their groups by it, split groups at key
     mismatches, and record the exact LCP at every new boundary from the
     xor of the adjacent windows.  Rounds deepen linearly; the tied set
     typically collapses geometrically (every mismatch inside the window
     resolves its pair exactly, and real-text context diverges fast).
  3. *Finish* the (now small) still-tied remainder on the host with the
     exact bounded-window comparison pass the small-residue path already
     uses (core/bigsort._resolve_residue_host) — it decides pairs at ANY
     depth, so correctness never depends on the round budget.

Constraints inherited from an earlier accelerator's compiler (to be
re-measured on the GPU, ROADMAP D3): no scan HLOs — segment ids come
from a log-step shifted-max ladder (``_prefix_max``), not cummax; window
reads gather one packed WORD per (row, word) from a precomputed table
(``pk``) instead of a byte per symbol (gathers were priced per element);
the tie flags are bit-packed 32x and both the packing and the pk table
build run as chunked donated-update loops so no full-size temp ever
coexists with the three build slabs.

Memory at the 1 GiB ladder config: text 1.07 + idx slab (refined in
place) 4.3 + lcp 4.3 (want_lcp) + packed masks 0.27 + pk 4.3 + one piece
(≤ 10 live int32 columns × 2^22) ≈ 14.4 GB — sized for a 16 GB device;
not re-derived for this card (ROADMAP D7).

Depth bookkeeping is in SYMBOLS (= bytes; every symbol codes one byte).
Refinement windows always use reserved-0 packing (past-the-end = 0 <
every real code) even when the main build packed minpad: a pair whose
shorter suffix ends inside a window separates at exactly the shorter
length, so deepening terminates for prefix pairs and the recorded LCP is
exact.  Minpad plans re-verify from depth 0 (a minpad "tie" can hide a
real pad-vs-min-symbol mismatch inside the original window); reserved-0
plans start at the already-verified depth.
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from hpc_suffix_array_tpu.core.bigsort import (
    _dev_pack_word, codes_from_bytes)

# Sentinel for pad SLOTS: above any legal n (int32 indexing caps n well
# below), far from the packed-word BIG used elsewhere — a 2^30 sentinel
# would collide with REAL slots the moment n exceeds 2^30.
SLOT_PAD = np.int32(0x7FFF0000)
CH = 1 << 24                     # slots per extraction / packing chunk


class RefineOverflow(NotImplementedError):
    """Refinement cannot finish within its caps (a single tie group
    larger than SA_REFINE_GROUP_MAX, or a still-tied remainder beyond
    the host budget after the round cap).  Subclasses
    NotImplementedError so the existing routing fallbacks catch it —
    the top-level router finishes with the host SA-IS builder, which
    handles any text (core/suffix_array.build_suffix_array)."""


# --------------------------------------------------------------------------
# Packed tie-flag mask (1 bit per SA slot), built chunk-by-chunk
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _pack_chunk(m: int, mask, flags_src, base, n):
    """Pack flags of slots [base, base+m) into mask (uint32, 32 per word).

    ``flags_src`` may be any array of length >= base (a build slab);
    reads past its end clamp — harmless, the ``pos < n`` mask zeroes
    everything at or past n either way."""
    w = lax.dynamic_slice(flags_src, (base,), (m,))
    pos = base + lax.iota(jnp.int32, m)
    bits = ((w != 0) & (pos < n)).astype(jnp.uint32).reshape(m // 32, 32)
    words = jnp.sum(bits << lax.iota(jnp.uint32, 32), axis=1)
    return lax.dynamic_update_slice(mask, words, (base // 32,))


@jax.jit
def _member_mask(tie_packed):
    """member[j] = tie[j] | tie[j+1] on the packed form.

    A tie flag marks the LATER element of a tied pair; a group's head
    joins via its successor's flag — the membership rule of
    core/bigsort._extract_ties."""
    down = tie_packed >> jnp.uint32(1)
    nxt = jnp.concatenate([tie_packed[1:], jnp.zeros(1, jnp.uint32)])
    return tie_packed | down | ((nxt & jnp.uint32(1)) << jnp.uint32(31))


@functools.partial(jax.jit, static_argnums=(1, 2))
def _popcount_chunks(packed, n_chunks: int, words_per_chunk: int):
    """Per-chunk set-bit counts: int32[n_chunks]."""
    w = packed.reshape(n_chunks, words_per_chunk)
    return jnp.sum(lax.population_count(w).astype(jnp.int32), axis=1)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _gather_windows(K: int, win_words: int, packed, starts_w):
    """(K, win_words) word windows of ``packed`` at ``starts_w`` — the
    piece partition fetches every candidate cut's neighborhood in ONE
    device call (not one host round-trip per candidate)."""
    rows = [lax.dynamic_slice(packed, (starts_w[k],), (win_words,))
            for k in range(K)]
    return jnp.stack(rows)


@functools.partial(jax.jit, static_argnums=(0,))
def _count_ranges(K: int, member_packed, los, his):
    """int32[K] member counts for K slot ranges in one device call."""
    L = member_packed.shape[0]
    widx = lax.iota(jnp.int32, L)
    pc = lax.population_count(member_packed).astype(jnp.int32)
    sh = lax.iota(jnp.uint32, 32)

    def one(lo, hi):
        word_lo, word_hi = lo // 32, (hi - 1) // 32
        inside = (widx > word_lo) & (widx < word_hi)
        full = jnp.sum(jnp.where(inside, pc, 0))

        def bits_of(wi):
            w = member_packed[jnp.clip(wi, 0, L - 1)]
            pos = wi * 32 + lax.iota(jnp.int32, 32)
            sel = ((w >> sh) & jnp.uint32(1)).astype(jnp.int32)
            return jnp.sum(jnp.where((pos >= lo) & (pos < hi), sel, 0))

        edge = bits_of(word_lo) + jnp.where(word_hi != word_lo,
                                            bits_of(word_hi), 0)
        return jnp.where(hi > lo, full + edge, 0)

    return jnp.stack([one(los[k], his[k]) for k in range(K)])


def _unpack_bits(words, m: int):
    """bool[m] from uint32[m/32] (little-endian)."""
    sh = lax.iota(jnp.uint32, 32)
    return ((words[:, None] >> sh[None, :]) & jnp.uint32(1)).reshape(
        m).astype(jnp.bool_)


@functools.partial(jax.jit, static_argnums=(0,),
                   donate_argnums=(1, 2, 3, 4))
def _extract_write(m: int, slotP, idxP, headP, off_d, tie_packed,
                   member_packed, sa_full, base, lo, hi, n):
    """Extract slot-chunk [base, base+m) ∩ [lo, hi) members and append
    them into the piece arrays at the DEVICE-resident running offset
    ``off_d`` (no host sync per chunk — per-chunk round-trips dominated
    extraction at the 1 GiB geometry on an earlier host, the same
    lesson as core/bigsort's count-free fill vector).

    Members compact first (ascending slot; SLOT_PAD pads; pad rows
    carry idx = n, head = 1).  Fixed-width m windows in ascending
    offset order: the spill past the true member count is healed by the
    next chunk's write / the piece arrays' m-slack tail.  ``head`` =
    NOT tie[slot]: the member starts a group."""
    w0 = base // 32
    tie_b = _unpack_bits(lax.dynamic_slice(tie_packed, (w0,), (m // 32,)),
                         m)
    mem_b = _unpack_bits(lax.dynamic_slice(member_packed, (w0,),
                                           (m // 32,)), m)
    slot = base + lax.iota(jnp.int32, m)
    mem_b = mem_b & (slot >= lo) & (slot < hi)
    idx = lax.dynamic_slice(sa_full, (base,), (m,))
    key = jnp.where(mem_b, slot, SLOT_PAD)
    idx = jnp.where(mem_b, idx, n)
    head = jnp.where(tie_b, 0, 1).astype(jnp.int32)
    s_key, s_idx, s_head = lax.sort((key, idx, head), num_keys=1,
                                    is_stable=False)
    off = off_d[0]
    return (lax.dynamic_update_slice(slotP, s_key, (off,)),
            lax.dynamic_update_slice(idxP, s_idx, (off,)),
            lax.dynamic_update_slice(headP, s_head, (off,)),
            off_d + jnp.sum(mem_b.astype(jnp.int32)))


@functools.partial(jax.jit, static_argnums=(0,))
def _piece_trim(S: int, slotP, idxP, headP, cnt, n):
    """Force rows at positions >= cnt to the pad state (the last
    extraction window's spill wrote arbitrary non-member rows there).
    Not donated: the outputs are S-shaped slices of (S+slack) inputs,
    which can never alias (donation would only warn)."""
    iota = lax.iota(jnp.int32, S)
    ok = iota < cnt
    return (jnp.where(ok, slotP[:S], SLOT_PAD),
            jnp.where(ok, idxP[:S], n),
            jnp.where(ok, headP[:S], 1))


# --------------------------------------------------------------------------
# Packed-word table over the text (reserved-0 codes), chunked build
# --------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 7),
                   donate_argnums=(3,))
def _pk_chunk(m: int, spw: int, bits: int, pk, text_pad, base, n,
              ranges=None, vals=None):
    """pk[base:base+m] = packed word of the spw reserved-0 codes at
    [i, i+spw) for each i.  Positions >= n code 0, so any row whose
    window starts at or past n reads the all-pad word; reads past the
    text buffer clamp and are masked the same way."""
    ext = lax.dynamic_slice(text_pad, (base,), (m + spw,))
    pos = base + lax.iota(jnp.int32, m + spw)
    codes = codes_from_bytes(ext, vals, ranges)
    codes = jnp.where(pos < n, codes, 0)
    word = _dev_pack_word(codes, 0, spw, bits, m)
    return lax.dynamic_update_slice(pk, word, (base,))


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 7),
                   donate_argnums=(3,))
def _pk2_chunk(m: int, spw: int, bits: int, pk2, text_pad, base, n,
               ranges=None, vals=None):
    """pk2[i] = (word at i, word at i+spw) as one (m, 2) row block.

    A contiguous PAIR row gather cost about the same as a
    single-element gather on an earlier accelerator (not re-measured on
    the GPU) — the rounds fetch both window words in ONE gather.  Costs 2x the
    table memory; the driver falls back to the 1-D table + two gathers
    when the fused-LCP build at huge n cannot afford it."""
    ext = lax.dynamic_slice(text_pad, (base,), (m + 2 * spw,))
    pos = base + lax.iota(jnp.int32, m + 2 * spw)
    codes = codes_from_bytes(ext, vals, ranges)
    codes = jnp.where(pos < n, codes, 0)
    w = _dev_pack_word(codes, 0, spw, bits, m + spw)
    pair = jnp.stack([lax.slice(w, (0,), (m,)),
                      lax.slice(w, (spw,), (spw + m,))], axis=1)
    return lax.dynamic_update_slice(pk2, pair, (base, 0))


# --------------------------------------------------------------------------
# Refinement rounds
# --------------------------------------------------------------------------


def _prefix_max(a):
    """Inclusive prefix max over a 1-D array, scan-free.

    log2(S) shifted-maximum steps — plain fused vector ops, no cummax
    HLO (an earlier remote compiler took minutes on it at these shapes;
    ROADMAP D3 asks whether cummax is as fast on the GPU).
    """
    S = a.shape[0]
    step = 1
    while step < S:
        lead = jnp.full((step,), jnp.iinfo(a.dtype).min, a.dtype)
        a = jnp.maximum(a, jnp.concatenate([lead, a[:-step]]))
        step *= 2
    return a


@functools.partial(jax.jit, static_argnums=(0,))
def _seg_init(S: int, head):
    """Initial segment ids: the position of each row's group head."""
    iota = lax.iota(jnp.int32, S)
    return _prefix_max(jnp.where(head != 0, iota, jnp.int32(-1)))


@functools.partial(jax.jit, static_argnums=(0, 1, 2))
def _piece_round1(m: int, spw: int, bits: int, tie_packed,
                  member_packed, sa_full, pk2, base, lo, hi, n, d0):
    """Fused extraction + first deepening round for a single-chunk
    piece (the common case: at benchmark sizes pieces ARE chunks).

    The staged form pays extract-sort -> windows -> trim -> seg ladder
    -> gather -> round sort as five dispatches with device-memory
    round-trips between them; this one program does: member/head masks from the
    packed flags, the positional slot compaction (1-key sort — the
    p-th sorted member row lands at the p-th smallest member slot:
    segment blocks are slot ranges, so the round-1 order's seg blocks
    align with ascending slot blocks), the paired window gather at the
    original depth, and the first (seg, w0, w1) split with its exact
    boundary-LCP patches.  Non-members key to the tail with DISTINCT
    pad segments (n + position — above every member head slot without
    int32 overflow) so no later round can see them as tied.  Returns
    (slotP, seg, idx, patch, n_tied) at shape m.
    """
    w0b = base // 32
    tie_b = _unpack_bits(lax.dynamic_slice(tie_packed, (w0b,),
                                           (m // 32,)), m)
    mem_b = _unpack_bits(lax.dynamic_slice(member_packed, (w0b,),
                                           (m // 32,)), m)
    slot = base + lax.iota(jnp.int32, m)
    mem_b = mem_b & (slot >= lo) & (slot < hi)
    idx = jnp.where(mem_b, lax.dynamic_slice(sa_full, (base,), (m,)),
                    n)
    slotP = lax.sort((jnp.where(mem_b, slot, SLOT_PAD),),
                     is_stable=False)[0]
    seg0 = _prefix_max(jnp.where(mem_b & (~tie_b), slot, jnp.int32(-1)))
    # Pad segments: distinct AND above every member segment (head
    # slots are < n). NOT SLOT_PAD + iota — that wraps past int32 for
    # chunks over 2^16 and the wrapped (negative) pads sort BEFORE the
    # members, misaligning rows against slotP.
    seg0 = jnp.where(mem_b, seg0, n + lax.iota(jnp.int32, m))
    g = pk2[jnp.minimum(idx + d0, jnp.int32(n))]
    patch = jnp.full((m,), -1, jnp.int32)
    return (slotP,) + _round_body(m, spw, bits, seg0, idx, patch,
                                  g[:, 0], g[:, 1], d0)


@functools.partial(jax.jit, static_argnums=(0, 1, 2),
                   donate_argnums=(3, 4, 5))
def _refine_round(S: int, spw: int, bits: int, seg, idx, patch, pk, d,
                  n):
    """One deepening round, paired-table flavor (pk is (L, 2) — both
    window words arrive in ONE row gather; see _pk2_chunk)."""
    nn = jnp.int32(n)
    g = pk[jnp.minimum(idx + d, nn)]
    return _round_body(S, spw, bits, seg, idx, patch, g[:, 0], g[:, 1],
                       d)


@functools.partial(jax.jit, static_argnums=(0, 1, 2),
                   donate_argnums=(3, 4, 5))
def _refine_round_1d(S: int, spw: int, bits: int, seg, idx, patch, pk,
                     d, n):
    """One deepening round, 1-D-table flavor (two element gathers) —
    the fallback when the paired table's 2x memory does not fit
    alongside a fused-LCP build at huge n."""
    nn = jnp.int32(n)
    g0 = pk[jnp.minimum(idx + d, nn)]
    g1 = pk[jnp.minimum(idx + d + spw, nn)]
    return _round_body(S, spw, bits, seg, idx, patch, g0, g1, d)


def _round_body(S: int, spw: int, bits: int, seg, idx, patch, g0, g1,
                d):
    """One deepening round over a piece (static shape S, traced depth d).

    Sort rows by (segment id, window word 0, window word 1); split
    segments at window mismatches; record the boundary LCP (= d + first
    differing symbol — exact, since all members of both subgroups share
    their windows) into the POSITIONAL patch array; reassign segment
    ids via the prefix-max ladder.  ``seg`` and ``patch`` are positional
    (rows only ever permute within their segment's position range, so a
    boundary formed at position p stays at p); ``idx`` travels with the
    rows.  Returns (seg, idx, patch, n_tied)."""
    s_seg, s0, s1, s_idx = lax.sort((seg, g0, g1, idx), num_keys=3,
                                    is_stable=False)
    m1 = jnp.full((1,), -1, jnp.int32)
    p_seg = jnp.concatenate([m1, s_seg[:-1]])
    p0 = jnp.concatenate([m1, s0[:-1]])
    p1 = jnp.concatenate([m1, s1[:-1]])
    parent_head = s_seg != p_seg
    wdiff = (s0 != p0) | (s1 != p1)
    new_head = parent_head | wdiff
    iota = lax.iota(jnp.int32, S)
    new_seg = _prefix_max(jnp.where(new_head, iota, jnp.int32(-1)))
    # Boundary LCP from the window xor: symbols pack first-highest, so
    # the highest set xor bit maps to the first differing symbol (the
    # want_lcp arithmetic of core/bigsort._bucket_sort).
    x0, x1 = s0 ^ p0, s1 ^ p1
    off0 = jnp.where(x0 != 0, spw - 1 - (31 - lax.clz(x0)) // bits,
                     jnp.int32(2 * spw))
    off1 = jnp.where(x1 != 0,
                     2 * spw - 1 - (31 - lax.clz(x1)) // bits,
                     jnp.int32(2 * spw))
    sym = jnp.where(x0 != 0, off0, off1)
    patch = jnp.where(wdiff & (~parent_head), d + sym, patch)
    n_tied = jnp.sum((~new_head).astype(jnp.int32))
    return new_seg, s_idx, patch, n_tied


@functools.partial(jax.jit, static_argnums=(0,))
def _tied_extract(S: int, seg, idx, slot):
    """Still-tied members of a refined piece, compacted first.

    A still-tied segment has >= 2 rows; every row of such a segment is
    a member (the host pass / the compacted continuation reorders whole
    groups).  Segments occupy contiguous POSITION ranges and ``slot``
    is ascending positional, so sorting members by slot preserves
    segment blocks — the head payload marks each block's start.
    Returns (slot[S]: ascending member slots then SLOT_PAD pads,
    idx[S] aligned, head int32[S], member count)."""
    p_seg = jnp.concatenate([jnp.full((1,), -1, jnp.int32), seg[:-1]])
    n_seg = jnp.concatenate([seg[1:], jnp.full((1,), -1, jnp.int32)])
    member = ((seg == p_seg) | (seg == n_seg)) & (slot < SLOT_PAD)
    head = (member & (seg != p_seg)).astype(jnp.int32)
    key = jnp.where(member, slot, SLOT_PAD)
    s_key, s_idx, s_head = lax.sort((key, idx, head), num_keys=1,
                                    is_stable=False)
    return s_key, s_idx, s_head, jnp.sum(member.astype(jnp.int32))


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_rows(sa_full, slot, idx):
    """sa_full[slot[p]] = idx[p] for real rows (SLOT_PAD rows drop —
    every legal n sits far below the sentinel)."""
    tgt = jnp.where(slot < SLOT_PAD, slot, jnp.int32(sa_full.shape[0]))
    return sa_full.at[tgt].set(idx, mode="drop")


@functools.partial(jax.jit, donate_argnums=(0,))
def _scatter_patch(lcp, slot, patch):
    """lcp[slot[p]] = patch[p] where a boundary value was recorded."""
    n = lcp.shape[0]
    tgt = jnp.where((patch >= 0) & (slot < n), slot, n)
    return lcp.at[tgt].set(jnp.maximum(patch, 0), mode="drop")


# --------------------------------------------------------------------------
# Driver
# --------------------------------------------------------------------------


def _pow2(x: int) -> int:
    return 1 << max(int(x - 1).bit_length(), 0) if x > 1 else 1


def _find_cut(fetch_tie, hi: int, lo: int) -> int | None:
    """Largest slot c in (lo, hi] with tie[c] == 0 (a clean piece cut:
    no tie group spans c).  ``fetch_tie(a, b)`` returns the packed tie
    words covering slots [a, b) as a host uint32 array."""
    W = 1 << 15
    c = hi
    while c > lo:
        a = max(lo, c - W)
        words = fetch_tie(a, c + 1)
        bits = np.unpackbits(
            words.view(np.uint8), bitorder="little")[:len(words) * 32]
        a_al = (a // 32) * 32
        sl = np.arange(a_al, a_al + len(bits))
        ok = (sl > lo) & (sl <= c) & (bits == 0)
        if ok.any():
            return int(sl[ok][-1])
        c = a
    return None


def refine_ties(text_pad, sa_full, lcp, tie_src, n: int, *, spw_main: int,
                d0_words: int, sigma: int, minpad: bool, ranges, vals,
                host_text, want_lcp: bool, meta: dict | None = None):
    """Resolve ALL window-tied groups of a carried-keys build exactly.

    Args:
      text_pad: device uint8[L], L > n, zero past n.
      sa_full:  device int32[>= n] — the build's order (slots [0, n)),
                tied groups in arbitrary order; REFINED IN PLACE via
                donated scatters (pass ownership; the returned array
                replaces it).  May be a build slab longer than n.
      lcp:      device int32[n] or None — tied rows hold lower bounds.
      tie_src:  device int32[>= min(len, n)] flags aligned to slots
                (tie[j]: slot j ties slot j-1); storage past n may be
                arbitrary (masked).  May be a build slab.
      spw_main, d0_words, minpad: the main build's packing — the
                verified depth is d0_words*spw_main symbols (minpad
                plans re-verify from 0, see module docstring).
      sigma:    alphabet size (reserved-0 refinement packing derives
                bits/spw from it).
      ranges/vals: the plan's device remap inputs (codes_from_bytes).
      host_text: np.uint8[n] for the exact host finish.
      meta:     optional dict; refinement stats are recorded into it.

    Returns (sa int32[n], lcp) with every tie resolved (lcp patched
    exactly when want_lcp).  Raises RefineOverflow when a cap is
    exceeded (see class docstring).
    """
    meta = meta if meta is not None else {}
    bits = max(1, int(sigma).bit_length())
    spw = 30 // bits
    d0 = 0 if minpad else d0_words * spw_main

    piece_target = int(os.environ.get("SA_REFINE_PIECE", 1 << 22))
    group_max = int(os.environ.get("SA_REFINE_GROUP_MAX", 1 << 26))
    max_rounds = int(os.environ.get("SA_REFINE_ROUNDS", 64))
    # 2^13 was best at 2^28 words on an earlier accelerator: one extra
    # compacted device round cost less than lexsorting 6x the members
    # on the host (not re-measured on the GPU).
    host_piece = int(os.environ.get("SA_REFINE_HOST_PIECE", 1 << 13))

    # Extraction/packing slot-chunk: scaled down with the piece target
    # so small targets actually produce multiple pieces (cuts are only
    # evaluated at chunk ends; members per chunk <= slots per chunk).
    ch = max(32, min(CH, _pow2(n), _pow2(4 * piece_target)))
    n_pack = -(-n // ch) * ch              # chunk-aligned slot span
    n_chunks = n_pack // ch

    # ---- pack the flags chunk-by-chunk; the int32 source can then go --
    # Chunked dynamic_slice needs sources at least one chunk long past
    # every base; small builds' slabs can be shorter than the chunk
    # grid (at benchmark sizes the slabs always dominate — no copy).
    if int(tie_src.shape[0]) < n_pack:
        tie_src = jnp.concatenate(
            [tie_src,
             jnp.zeros((n_pack - int(tie_src.shape[0]),), tie_src.dtype)])
    if int(text_pad.shape[0]) < n_pack + 2 * spw:
        # The paired pk builder slices m + 2*spw per chunk; pad once so
        # both table flavors' chunked reads stay in bounds.
        text_pad = jnp.concatenate(
            [text_pad,
             jnp.zeros((n_pack + 2 * spw - int(text_pad.shape[0]),),
                       text_pad.dtype)])
    tie_packed = jnp.zeros((n_pack // 32,), jnp.uint32)
    for c in range(n_chunks):
        tie_packed = _pack_chunk(ch, tie_packed, tie_src,
                                 jnp.int32(c * ch), jnp.int32(n))
    del tie_src
    member_packed = _member_mask(tie_packed)

    counts = np.asarray(jax.device_get(_popcount_chunks(
        member_packed, n_chunks, ch // 32))).astype(np.int64)
    M = int(counts.sum())
    meta["refine_members"] = M
    if M == 0:
        if lcp is not None and int(lcp.shape[0]) > n:
            lcp = lcp[:n]
        return sa_full[:n], lcp

    if int(sa_full.shape[0]) < n_pack:
        sa_full = jnp.concatenate(
            [sa_full,
             jnp.zeros((n_pack - int(sa_full.shape[0]),), jnp.int32)])

    def fetch_tie(a: int, b: int) -> np.ndarray:
        wa, wb = a // 32, min(-(-b // 32), n_pack // 32)
        return np.asarray(jax.device_get(tie_packed[wa:wb]))

    # ---- piece partition at clean cuts (batched round-trips) ----------
    # Three device calls total, independent of piece count: the
    # previous per-piece fetch pattern cost 2-3 host round-trips per
    # piece.
    #   1. candidate piece-closing chunk ends from the per-chunk counts
    #      (host-only walk; a split chunk's remainder is approximated
    #      by its whole count — piece sizes are targets, not contracts);
    #   2. ONE gather of a tie-flag window per candidate to snap each
    #      end to the nearest clean cut (a slot whose tie flag is 0);
    #   3. ONE call for every piece's exact member count.
    cand = []
    acc = 0
    for c in range(n_chunks):
        acc += int(counts[c])
        if acc >= piece_target or c == n_chunks - 1:
            cand.append(c)
            acc = 0
    W = 1 << 15
    win_words = min(W // 32, n_pack // 32)
    ends = [min((c + 1) * ch, n) for c in cand]
    starts_w = np.array(
        [min(max(0, e - W) // 32, n_pack // 32 - win_words)
         for e in ends], np.int32)
    wins = np.asarray(jax.device_get(_gather_windows(
        len(cand), win_words, tie_packed, jnp.asarray(starts_w))))

    bounds = []                  # (lo_slot, hi_slot)
    lo = 0
    for e, sw, win in zip(ends, starts_w, wins):
        if e >= n:
            hi = n
        else:
            bits_w = np.unpackbits(win.view(np.uint8),
                                   bitorder="little")
            sl = np.arange(int(sw) * 32, int(sw) * 32 + len(bits_w))
            ok = (sl > lo) & (sl <= e) & (bits_w == 0)
            if ok.any():
                hi = int(sl[ok][-1])
            else:
                # Giant group across the whole window: fall back to the
                # scanning search (rare); still no cut -> extend into
                # the next candidate's range.
                cut = _find_cut(fetch_tie, e, lo)
                if cut is None:
                    continue
                hi = cut
        if hi <= lo:
            continue
        bounds.append((lo, hi))
        lo = hi
    cnts = np.asarray(jax.device_get(_count_ranges(
        len(bounds), member_packed,
        jnp.asarray(np.array([b[0] for b in bounds], np.int32)),
        jnp.asarray(np.array([b[1] for b in bounds], np.int32)))))
    pieces = []                  # (lo_slot, hi_slot, member_count)
    for (plo, phi), cnt in zip(bounds, cnts):
        cnt = int(cnt)
        if cnt > group_max:
            raise RefineOverflow(
                f"refinement piece [{plo},{phi}) holds {cnt} tied "
                f"members (> SA_REFINE_GROUP_MAX={group_max}); a tie "
                "group exceeds the device sort budget - the router "
                "finishes with the host SA-IS builder")
        if cnt:
            pieces.append((plo, phi, cnt))
    assert sum(c for _, _, c in pieces) == M, (sum(
        c for _, _, c in pieces), M)
    meta["refine_pieces"] = len(pieces)

    # ---- packed-word table (reserved-0), chunked build ----------------
    # One pad chunk past n_pack guarantees pk[n] is the all-pad word
    # even when n is chunk-aligned (the gathers clamp to n). The paired
    # (L, 2) table halves the rounds' gather cost (one row gather per
    # round, see _pk2_chunk) but costs 2x memory: the fused SA+LCP
    # build at huge n keeps the 1-D table instead (at 2^30 the live set
    # there is text + idx slab + lcp + masks ~ 10 GB; +8.6 GB paired
    # table would not fit, +4.3 does). Sized for a 16 GB device; not
    # re-derived for this card (ROADMAP D7).
    import time as _time

    _t0 = _time.perf_counter()
    paired = (not want_lcp) or n <= (1 << 29) or \
        os.environ.get("SA_REFINE_PK2", "auto") == "1"
    if os.environ.get("SA_REFINE_PK2", "auto") == "0":
        paired = False
    if paired:
        pk = jnp.zeros((n_pack + ch, 2), jnp.int32)
        for c in range(n_chunks):
            pk = _pk2_chunk(ch, spw, bits, pk, text_pad,
                            jnp.int32(c * ch), jnp.int32(n), ranges,
                            vals)
        _ = jax.device_get(pk[-1, 0])
    else:
        pk = jnp.zeros((n_pack + ch,), jnp.int32)
        for c in range(n_chunks):
            pk = _pk_chunk(ch, spw, bits, pk, text_pad,
                           jnp.int32(c * ch), jnp.int32(n), ranges,
                           vals)
        _ = jax.device_get(pk[-1])
    round_fn = _refine_round if paired else _refine_round_1d
    phases = {"pk": round(_time.perf_counter() - _t0, 3),
              "extract": 0.0, "rounds": 0.0, "host_fetch": 0.0}

    host_patches = []            # (slots int64[], idxs int32[])
    rounds_max = 0
    for (plo, phi, cnt) in pieces:
        _t0 = _time.perf_counter()
        # Fused entry only when the piece is one chunk AND dense: the
        # fused program works at full chunk width, which beats the
        # staged pipeline's five dispatches when most rows are members
        # (words corpora: 67-92%) but wastes a chunk-wide sort on
        # sparse tie masses where the staged path's pow2(cnt) shapes
        # are tiny.
        single = (paired and plo // ch == (phi - 1) // ch
                  and cnt >= ch // 8)
        if single:
            # Fused extraction + first deepening round: one program,
            # uniform chunk-wide shape (see _piece_round1).
            S = ch
            slotP, seg, idxP, patch, tied_d = _piece_round1(
                ch, spw, bits, tie_packed, member_packed, sa_full, pk,
                jnp.int32((plo // ch) * ch), jnp.int32(plo),
                jnp.int32(phi), jnp.int32(n), jnp.int32(d0))
            tied = int(jax.device_get(tied_d))
            d = d0 + 2 * spw
            rounds = 1
        else:
            S = max(_pow2(cnt), min(1 << 10, _pow2(n)))
            slotP = jnp.full((S + ch,), SLOT_PAD, jnp.int32)
            idxP = jnp.full((S + ch,), jnp.int32(n), jnp.int32)
            headP = jnp.ones((S + ch,), jnp.int32)
            off_d = jnp.zeros((1,), jnp.int32)
            for c in range(plo // ch, (phi - 1) // ch + 1):
                slotP, idxP, headP, off_d = _extract_write(
                    ch, slotP, idxP, headP, off_d, tie_packed,
                    member_packed, sa_full, jnp.int32(c * ch),
                    jnp.int32(plo), jnp.int32(phi), jnp.int32(n))
            if os.environ.get("SA_REFINE_CHECK", "0") == "1":
                # Debug invariant (one sync per piece): the device
                # running offset must land exactly on the batched range
                # count. Default-off — the global sum==M assert above
                # plus the oracle/validator layers cover it.
                assert int(jax.device_get(off_d)[0]) == cnt, (off_d,
                                                              cnt)
            slotP, idxP, headP = _piece_trim(S, slotP, idxP, headP,
                                             jnp.int32(cnt),
                                             jnp.int32(n))
            seg = _seg_init(S, headP)
            del headP
            patch = jnp.full((S,), -1, jnp.int32)
            d = d0
            tied = cnt
            rounds = 0
        phases["extract"] += _time.perf_counter() - _t0
        _t0 = _time.perf_counter()

        while tied and rounds < max_rounds and tied > host_piece:
            if tied <= S // 4 and S > (1 << 12):
                # Geometric compaction: most rows resolve in the first
                # round or two; continuing at full width would make
                # every deepening round cost like the first. Commit the
                # resolved rows now, shrink to the still-tied members,
                # and keep deepening in the smaller shape.
                sa_full = _scatter_rows(sa_full, slotP, idxP)
                if want_lcp:
                    lcp = _scatter_patch(lcp, slotP, patch)
                s_key, s_idx, s_head, mc_d = _tied_extract(
                    S, seg, idxP, slotP)
                mc = int(jax.device_get(mc_d))
                S2 = max(_pow2(mc), 1 << 10)
                slotP, idxP, headC = _piece_trim(
                    S2, s_key[:S2], s_idx[:S2], s_head[:S2],
                    jnp.int32(mc), jnp.int32(n))
                del s_key, s_idx, s_head
                seg = _seg_init(S2, headC)
                del headC
                patch = jnp.full((S2,), -1, jnp.int32)
                S = S2
            seg, idxP, patch, tied_d = round_fn(
                S, spw, bits, seg, idxP, patch, pk, jnp.int32(d),
                jnp.int32(n))
            tied = int(jax.device_get(tied_d))
            d += 2 * spw
            rounds += 1
        rounds_max = max(rounds_max, rounds)
        phases["rounds"] += _time.perf_counter() - _t0
        _t0 = _time.perf_counter()
        if tied:
            s_key, s_idx, _s_head, mcount_d = _tied_extract(
                S, seg, idxP, slotP)
            mcount = int(jax.device_get(mcount_d))
            if mcount > 4 * host_piece:
                raise RefineOverflow(
                    f"{mcount} members still tied after {rounds} "
                    "refinement rounds (> 4*SA_REFINE_HOST_PIECE) - the "
                    "router finishes with the host SA-IS builder")
            k = min(S, _pow2(max(mcount, 2)))
            host_patches.append((
                np.asarray(jax.device_get(s_key[:k]))[:mcount]
                .astype(np.int64),
                np.asarray(jax.device_get(s_idx[:k]))[:mcount]))
            del s_key, s_idx
        sa_full = _scatter_rows(sa_full, slotP, idxP)
        if want_lcp:
            lcp = _scatter_patch(lcp, slotP, patch)
        del slotP, idxP, seg, patch
        phases["host_fetch"] += _time.perf_counter() - _t0

    del tie_packed, member_packed, pk
    meta["refine_phase_s"] = {k: round(v, 3) for k, v in phases.items()}
    if lcp is not None and int(lcp.shape[0]) > n:
        lcp = lcp[:n]            # free a slab-length lcp buffer
    meta["refine_rounds"] = rounds_max
    meta["refine_host_members"] = int(
        sum(len(s) for s, _ in host_patches))

    sa_out = sa_full[:n] if int(sa_full.shape[0]) > n else sa_full
    del sa_full
    if host_patches:
        from hpc_suffix_array_tpu.core.bigsort import _apply_residue
        sa_out, lcp, n_host = _apply_residue(
            sa_out, lcp, host_text, host_patches, n, want_lcp)
        meta["n_patched"] = meta.get("n_patched", 0) + n_host
    return sa_out, lcp
