"""Out-of-core single-chip suffix sort: the 1 GiB class.

The prefix-doubling kernel (core/suffix_array.py) holds ~30 B of device
state per input char during its pair sort, so on a 16 GB device it caps
single-chip builds near 256 MB. This module covers the 1 GiB ladder
config of BASELINE.md with an algorithm whose phases each stay under
~15 GB (sized for a 16 GB device; not re-derived for this card, ROADMAP
D7) and whose programs follow three rules an earlier accelerator's
compiler imposed (not re-measured on the GPU, ROADMAP D3):

  * no scan ops (cummax/cumsum/associative_scan) or lax.map — every
    program here is sort/slice/reduce/DUS;
  * the design CARRIES sort keys through the data movement instead of
    gathering windows per bucket (gathers were priced per element);
  * masked read-modify-write on a donated buffer (read `cur`, select,
    write back at dynamic offsets) defeats XLA's in-place aliasing — it
    inserts a full-buffer copy that made the 2^30 compile run out of
    memory. Every slab write below is therefore UNMASKED full-width,
    with layout gaps sized so the spilled tail is either overwritten by
    the next writer or lands in dead space.

**Carried-keys MSD bucket sort (bucket-major, three passes).**

  1. *Plan (host)*: dense alphabet remap (core alphabet_remap) packs
     ``spw = 30//bits`` symbols per int32 word; each suffix gets two
     words k0, k1 = its first 2*spw symbols (6 for bytes, 10 for alnum,
     20 for DNA — sized so the expected number of SA pairs still tied
     after 2*spw symbols stays within the bounded residue for random-ish
     texts at 2^30). Symbol 0 is reserved for past-the-end so a shorter
     suffix that is a prefix of a longer one orders first (the reference
     gets this from strcmp, src/sequential/manber_myers.c:195). Bucket
     edges = quantiles of sampled (k0, k1) pairs.
  2. *Layout (host, count-free since r3)*: the slab geometry comes from
     the edge sampler's per-bucket fill fractions plus a margin — no
     standalone count pass (it cost 0.69 s of the 8.7 s r2 build). The
     exact two-pass layout (``_count_chunks``) survives as the fallback
     for genuinely skewed texts, reached via an overflow-triggered
     rerun recorded in ``meta["rerun"]``. Bucket b's runs (one per
     chunk) sit back-to-back at ``base[b]``, followed by a gap ``G_b``
     that absorbs write spill (below).
  3. *Scatter (device, C chunk passes)*: sort each chunk by bucket id,
     find its exact run boundaries with a two-level in-program boundary
     search on the sorted keys, take run destinations from a
     device-resident running-fill vector, and write every run with one
     fixed-width W window per (chunk, bucket). The W-window tail spills
     PAST the run's true length — exactly onto the region the NEXT
     chunk's run writes, so sequential chunk order heals every spill;
     the last chunk's spill lands in the bucket's gap.
  4. *Bucket passes*: each bucket is now contiguous — one dynamic slice,
     one 3-key sort, and a write of the sorted order DIRECTLY to the
     bucket's final SA offset ``out_base[b] = sum(fills[<b])``. Compact
     writes are back-to-back ascending, each overwriting its
     predecessor's padded spill, and the gap geometry guarantees no
     write ever touches a not-yet-read key region. After the last
     bucket, the idx slab's first n elements ARE the suffix array — no
     assembly phase. The sort (reads slabs) and the write (donated
     slabs, ZERO reads) are separate programs so in-place aliasing is
     structurally safe.
  5. *Residue*: pairs still tied after 2*spw symbols are extracted
     (bounded), resolved by direct comparison on the HOST (which has the
     text), and patched into the SA at their (already global) slots.
  6. *Periodic chain mode*: when most of the text ties (globally
     periodic input, the reference's repetitive corpus family),
     re-running the bucket sort with a DESCENDING idx tiebreak is exact:
     for a verified global period d, s_{i+d} is a strict prefix of s_i,
     so every tie chain orders by descending index (telescoping
     comparison). Verification = one streaming period sweep + uniform
     chain-delta check; non-conforming texts fail loudly.

  7. *LCP for free* (``want_lcp``): the carried keys hold each suffix's
     first 2*spw symbols, so once sorted, adjacent xor + clz yields the
     LCP array exactly for every pair that mismatches inside the window
     — the same residue bound as the SA itself. Tied pairs take the
     chain rule (periodic) or the host residue comparison (bounded).
     This is the 1 GiB-class LCP path: a standalone LCP build would
     need the same full-text sort as the SA.

Behavioral parity: byte-identical suffix array to the reference's
``build_suffix_array`` (src/sequential/manber_myers.c:81-133) and LCP
array to its Kasai builder (src/sequential/manber_myers.c:135-157);
this is an algorithmic replacement for scale, validated against the
same oracles.
"""

from __future__ import annotations

import functools
import math
import os
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from hpc_suffix_array_tpu.core.suffix_array import (
    alphabet_remap, as_byte_array, bucket_size)

# > any 30-bit packed word. np.int32 (not jnp): a module-scope jnp
# constant eagerly creates a device buffer at import, initializing the
# backend (and reserving device memory) before any caller can configure
# platforms/meshes.
PAD_KEY = np.int32(1 << 30)
RESIDUE_SLOTS = 1 << 15          # extracted tie pairs per bucket (fetch cap)
HALO = 128                       # text halo: >= 3*spw + slack symbols
MAX_PASS_ELEMS = 1 << 28         # padded elements one bucket sort may hold
#   (~8 live int32 arrays during the 3-key sort -> ~8.6 GB at the cap;
#    beyond it one bucket dominates the text and this path can't help).
#   Sized for a 16 GB device; not re-derived for this card (ROADMAP D7).


@dataclass
class BigPlan:
    """Host-side plan: geometry, alphabet packing, bucket edges."""

    n: int
    m: int                      # chunk width (position space)
    n_chunks: int
    bits: int                   # bits per dense symbol code
    spw: int                    # symbols packed per key word (30 // bits)
    remap: np.ndarray           # uint8 -> dense code (1..sigma), int32[256]
    e0: np.ndarray              # int32[E] edge k0 words
    e1: np.ndarray              # int32[E] edge k1 words
    minpad: bool = False        # 0-based codes, past-end = min symbol
    counts: np.ndarray | None = None    # (C, NB) run lengths
    meta: dict = field(default_factory=dict)

    @property
    def n_buckets(self) -> int:
        return len(self.e0) + 1


def packing_from_sigma(sigma: int) -> tuple[int, int, bool]:
    """(bits, spw, minpad) for the carried-key paths.

    Default ("reserved-0") packing maps real symbols to 1..sigma and
    past-the-end positions to 0, so a shorter suffix that is a prefix
    of a longer one strictly orders first inside the key window — the
    strcmp semantics of the reference (manber_myers.c:195). That costs
    one code point: a power-of-two alphabet needs an extra bit.

    ``minpad`` packing drops the reserved 0 (codes 0..sigma-1) and maps
    past-the-end to 0 = the MINIMUM real symbol. Padding with the
    minimal symbol can never strictly misorder a pair: wherever the
    true comparison ends a suffix (it wins immediately), the padded
    comparison sees the minimal continuation — which either still wins
    or TIES, and window-tied pairs are resolved exactly by the host
    residue pass / chain rule (which know true lengths). The payoff is
    packing density where sigma is a power of two: DNA carries 15
    symbols per word instead of 10 (2 bits vs 3), collapsing the
    expected window-tied residue by sigma^(extra symbols) — at 2^30 DNA
    from ~1M pairs to ~1. Chosen automatically whenever it deepens the
    window. The key-derived LCP must then clamp to the pair's shorter
    suffix length (see _bucket_sort); with reserved-0 packing that
    clamp is a provable no-op (the pad code 0 mismatches every real
    symbol at exactly the shorter suffix's end).
    """
    k = max(int(sigma), 1)
    bits_res = max(1, k.bit_length())
    if k >= 2:
        bits_mp = max(1, (k - 1).bit_length())
        if 30 // bits_mp > 30 // bits_res:
            return bits_mp, 30 // bits_mp, True
    return bits_res, 30 // bits_res, False


def packing_mode(remap: np.ndarray) -> tuple[int, int, bool]:
    """(bits, spw, minpad) from a dense alphabet remap table."""
    return packing_from_sigma(int(remap.max()))


def _host_pack_words(arr, remap, pos, spw: int, bits: int, word: int,
                     minpad: bool = False):
    """k{word} for sampled positions (host mirror of the device packing)."""
    n = len(arr)
    shift = 1 if minpad else 0
    out = np.zeros(len(pos), np.int64)
    for s in range(spw):
        p = pos + word * spw + s
        code = np.where(p < n, remap[arr[np.minimum(p, n - 1)]] - shift, 0)
        out = (out << bits) | code
    return out


def sample_edges(arr: np.ndarray, remap, spw: int, bits: int,
                 target_bucket: int, sample: int = 1 << 21,
                 seed: int = 0x5A, k0_only: bool | None = None,
                 with_fracs: bool = False, minpad: bool = False):
    """Quantile bucket edges over sampled keys (host).

    Prefers k0-only edges (e1 = all zeros, making the bucket id a
    function of k0 alone): the scatter pass can then group chunks with a
    1-key sort, which was cheaper than the 2-key one, and the replan
    packs half the words. Falls back to (k0, k1) pair edges
    when the sampled k0 quantiles predict an oversized bucket (heavy
    first-word duplication). ``k0_only`` forces the mode (tests).

    ``with_fracs``: also return the SAMPLED per-bucket fill fractions
    (float64[n_buckets], summing to 1) — the count-free scatter sizes
    its per-bucket capacities from these, which tracks discrete-value
    mass granularity (e.g. periodic texts with ~1000 distinct k0s) that
    a uniform n/NB assumption misses (sampling noise ~sqrt(NB/sample)).
    """
    n = len(arr)
    n_buckets = max(2, math.ceil(n / target_bucket))
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, n, min(sample, 4 * n))
    c0 = _host_pack_words(arr, remap, pos, spw, bits, 0, minpad)
    if k0_only is not False:
        c0s = np.sort(c0)
        q = (np.arange(1, n_buckets) * len(c0s)) // n_buckets
        e0 = np.unique(c0s[q])
        cuts = np.searchsorted(c0s, e0, side="left")
        sizes = np.diff(np.r_[0, cuts, len(c0s)])
        # Sampling error at 2M samples is <1% per bucket; 0.7x the pass
        # cap leaves margin, and 4x the target keeps W (max per-chunk
        # run, hence slab gap width) from bloating the slabs.
        worst = sizes.max() / max(len(c0s), 1) * n
        if len(e0) and worst <= min(0.7 * MAX_PASS_ELEMS,
                                    4 * target_bucket):
            out = (e0.astype(np.int32), np.zeros(len(e0), np.int32))
            if with_fracs:
                return out + (sizes / max(len(c0s), 1),)
            return out
        if k0_only:
            raise ValueError("k0-only edges requested but the sampled "
                             "k0 distribution is too skewed")
    c1 = _host_pack_words(arr, remap, pos, spw, bits, 1, minpad)
    code = (c0.astype(np.int64) << 31) | c1
    code.sort()
    q = (np.arange(1, n_buckets) * len(code)) // n_buckets
    edges = np.unique(code[q])
    out = ((edges >> 31).astype(np.int32),
           (edges & ((1 << 31) - 1)).astype(np.int32))
    if with_fracs:
        cuts = np.searchsorted(code, edges, side="left")
        return out + (np.diff(np.r_[0, cuts, len(code)]) / max(len(code),
                                                               1),)
    return out


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 5, 9))
def _sample_k0_device(n_edges: int, m_s: int, stride: int, spw: int,
                      bits: int, ranges, text_pad, vals, n,
                      minpad: bool = False):
    """k0-only quantile edges, entirely on device (strided sample).

    The host sampler costs ~0.6 s per re-plan at 1 GiB (random fancy
    indexing over the host text); this one reshapes the device text into
    (m_s, stride) rows — a free layout view, no gathers — packs the
    first spw bytes of each row into a k0 word, sorts the 2M sample, and
    takes quantiles. Duplicate quantile values are KEPT (they make empty
    buckets, which the slab layout already skips) so the output shape is
    static. Strided sampling is unbiased on non-periodic texts; periodic
    texts route to chain mode before edges matter.
    """
    ext = lax.slice(text_pad, (0,), (m_s * stride,))
    blk = ext.reshape(m_s, stride)[:, :spw]
    codes = codes_from_bytes(blk, vals, ranges)
    pos = lax.iota(jnp.int32, m_s) * stride
    codes = jnp.where((pos[:, None] + lax.iota(jnp.int32, spw)) < n,
                      codes - (1 if minpad else 0), 0)
    k0 = jnp.zeros((m_s,), jnp.int32)
    for s in range(spw):
        k0 = (k0 << bits) | codes[:, s]
    # Invalid rows (start past n) sort to +inf and shrink the effective
    # sample; quantile slots index only the valid prefix.
    k0 = jnp.where(pos < jnp.maximum(n - spw, 1), k0, jnp.int32(2) << 29)
    k0 = lax.sort((k0,))[0]
    n_valid = jnp.clip((jnp.maximum(n - spw, 1) + stride - 1) // stride,
                       1, m_s)
    q = (jnp.arange(1, n_edges + 1, dtype=jnp.int32)
         * n_valid) // jnp.int32(n_edges + 1)
    edges = jnp.take(k0, q)
    # Sampled fill cuts (count-free capacity sizing): invalid rows sort
    # past every real edge, so they never perturb the counts.
    cuts = jnp.searchsorted(k0, edges, side="left").astype(jnp.int32)
    return edges, cuts, n_valid


def replan_edges(state, text=None) -> None:
    """Refresh the plan's bucket edges in place (the bench re-plan step).

    Uses the device sampler when the plan runs k0-only edges with a
    range-mappable alphabet; falls back to the host sampler otherwise
    (``text`` required there)."""
    plan: BigPlan = state["plan"]
    ranges = state.get("ranges")
    if not plan.e1.any() and ranges is not None:
        ne = len(plan.e0)
        stride = max(2 * plan.spw, plan.n // (1 << 21) or 1)
        m_s = min(1 << 21, plan.n // stride or 1)
        plan.e0, cuts, n_valid = _sample_k0_device(
            ne, m_s, stride, plan.spw, plan.bits, ranges,
            state["text_pad"], state["vals_d"], jnp.int32(plan.n),
            plan.minpad)
        cuts_h, nv = jax.device_get((cuts, n_valid))
        plan.meta["fill_frac"] = (
            np.diff(np.r_[0, np.asarray(cuts_h), int(nv)])
            / max(int(nv), 1))
        return
    plan.e0, plan.e1, plan.meta["fill_frac"] = sample_edges(
        np.asarray(text if text is not None else state["host_text"]),
        plan.remap, plan.spw, plan.bits,
        plan.meta.get("target_bucket", 1 << 23), with_fracs=True,
        minpad=plan.minpad)


def _dev_pack_word(codes_ext, offset: int, spw: int, bits: int, m: int):
    """Packed word of spw codes starting at element offset (static fold)."""
    out = jnp.zeros((m,), jnp.int32)
    for s in range(spw):
        out = (out << bits) | lax.slice(
            codes_ext, (offset + s,), (offset + s + m,))
    return out


def byte_ranges(remap: np.ndarray, cap: int = 16
                ) -> tuple[tuple[int, int, int], ...] | None:
    """Present bytes as contiguous (lo, hi, run_len) ranges, or None.

    The dense remap of most real alphabets is piecewise linear over a
    handful of byte ranges (alnum: 3, DNA: 4, full bytes: 1) — the
    device code can then be ~5 fused ops per range instead of one
    compare per present VALUE. None = too fragmented (> ``cap`` ranges); callers fall
    back to the compare-sum over present values.
    """
    present = np.flatnonzero(remap > 0)
    if len(present) == 0:
        return ((0, 0, 0),)
    cuts = np.flatnonzero(np.diff(present) > 1)
    starts = np.r_[0, cuts + 1]
    ends = np.r_[cuts, len(present) - 1]
    ranges = tuple((int(present[s]), int(present[e]), int(e - s + 1))
                   for s, e in zip(starts, ends))
    return ranges if len(ranges) <= cap else None


def codes_from_bytes(ext, vals, ranges):
    """Dense codes (1..sigma, byte order) for a uint8 vector, no gather.

    ``ranges`` static ((lo, hi, len), ...) -> piecewise-linear remap
    (~5 ops/range); None -> compare-sum over the present byte values
    ``vals`` (code(x) = #present bytes <= x). Both avoid the table
    gather, which was priced per element on an earlier accelerator,
    while these fuse into the consumer (not re-measured on the GPU).
    """
    if ranges is not None:
        x = ext.astype(jnp.int32)
        code = jnp.zeros(x.shape, jnp.int32)
        for lo, hi, ln in ranges:
            code = code + jnp.where(
                x > hi, ln, jnp.maximum(x - (lo - 1), 0))
        return code
    return jnp.sum((ext[..., None] >= vals).astype(jnp.int32), axis=-1)


def _chunk_codes(m: int, spw: int, bits: int, text_pad, vals, start, n,
                 static_start: int | None = None, ranges=None,
                 k1_too: bool = True, minpad: bool = False):
    """(k0, k1) carried key words for one chunk (see codes_from_bytes).

    ``k1_too=False`` skips the second word (k0-only consumers like the
    count fast path). ``minpad``: 0-based codes with past-the-end as
    the minimum symbol (see packing_from_sigma)."""
    w = 2 * spw if k1_too else spw
    if static_start is None:
        ext = lax.dynamic_slice(text_pad, (start,), (m + 2 * spw,))
    else:
        ext = lax.slice(text_pad, (static_start,),
                        (static_start + m + w,))
    pos_ext = start + lax.iota(jnp.int32, m + w)
    codes = codes_from_bytes(ext[:m + w], vals, ranges)
    codes = jnp.where(pos_ext < n, codes - (1 if minpad else 0), 0)
    k0 = _dev_pack_word(codes, 0, spw, bits, m)
    k1 = _dev_pack_word(codes, spw, spw, bits, m) if k1_too else None
    return k0, k1


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 9, 10, 11))
def _count_chunks(C: int, m: int, spw: int, bits: int, text_pad, vals,
                  e0, e1, n, ranges=None, k0_only: bool = False,
                  minpad: bool = False):
    """(C, E) histogram rows cnt_ge[c, e] = #{real pairs >= edge e}, ONE
    dispatch. Per-bucket run lengths follow on the host by differencing
    (bid is the number of edges at or below the pair, so bid >= e+1 is
    exactly pair >= edge_e). Built from pack + compare + reduce only —
    no sort, no gather — so it is cheap to run and to compile.
    ``k0_only`` (host-known: e1 all zeros) compares the first word alone
    and skips packing k1 — the (m, E) compare work is the pass's cost
    and this cuts it ~3x (the compare is n x E, E=127 at 1 GiB).
    """
    rows = []
    for c in range(C):
        if k0_only:
            k0 = _chunk_codes(m, spw, bits, text_pad, vals,
                              jnp.int32(c * m), n, static_start=c * m,
                              ranges=ranges, k1_too=False,
                              minpad=minpad)[0]
            ok = (c * m + lax.iota(jnp.int32, m)) < n
            ge = (k0[:, None] >= e0) & ok[:, None]
        else:
            k0, k1 = _chunk_codes(m, spw, bits, text_pad, vals,
                                  jnp.int32(c * m), n, static_start=c * m,
                                  ranges=ranges, minpad=minpad)
            ok = (c * m + lax.iota(jnp.int32, m)) < n
            ge = ((k0[:, None] > e0) | ((k0[:, None] == e0)
                                        & (k1[:, None] >= e1))) & ok[:, None]
        rows.append(jnp.sum(ge.astype(jnp.int32), axis=0))
    return jnp.stack(rows)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 14, 15),
                   donate_argnums=(5, 6, 7))
def _scatter_chunk(m: int, spw: int, bits: int, W: int, keys: int,
                   k0B, k1B, idxB, text_pad, vals, dest, bnd, start, n,
                   ranges=None, minpad: bool = False):
    """Distribute one chunk into the bucket-major slabs (spill-forward).

    One 3-operand sort: bucket id is monotone in the key pair, so the
    sorted chunk is already bucket-run-contiguous, and the run
    boundaries ``bnd[b]`` are host-known from the count pass — no bid
    column, no searchsorted. With k0-only edges (e1 all zeros, see
    sample_edges) the bucket id is a function of k0 alone and ``keys``
    is 1 — k1 rides as payload. ``dest[b]`` is THIS chunk's run
    destination for bucket b.
    Each run is written as one unmasked W-wide window; the tail past the
    run's true length spills onto the region the next chunk's run writes
    (healed by chunk order) or the bucket gap. The donated slabs are
    never READ here, so XLA aliases them in place with no copy.
    """
    NB = dest.shape[0]
    k0, k1 = _chunk_codes(m, spw, bits, text_pad, vals, start, n,
                          ranges=ranges, minpad=minpad)
    pos = start + lax.iota(jnp.int32, m)
    ok = pos < n
    k0 = jnp.where(ok, k0, PAD_KEY)
    k1 = jnp.where(ok, k1, PAD_KEY)
    # Sort width m + W so run reads never hit the clamp of dynamic_slice.
    padk = jnp.full((W,), PAD_KEY, jnp.int32)
    s_k0, s_k1, s_idx = lax.sort(
        (jnp.concatenate([k0, padk]), jnp.concatenate([k1, padk]),
         jnp.concatenate([pos, padk])),
        num_keys=keys, is_stable=False)
    # Fence the sorted arrays before the window loop: without it XLA
    # fused/rematerialized the window slices into the sort's output
    # copies, which doubled the pass on an earlier accelerator (not
    # re-measured on the GPU).
    s_k0, s_k1, s_idx = lax.optimization_barrier((s_k0, s_k1, s_idx))
    for b in range(NB):
        k0B = lax.dynamic_update_slice(
            k0B, lax.dynamic_slice(s_k0, (bnd[b],), (W,)), (dest[b],))
        k1B = lax.dynamic_update_slice(
            k1B, lax.dynamic_slice(s_k1, (bnd[b],), (W,)), (dest[b],))
        idxB = lax.dynamic_update_slice(
            idxB, lax.dynamic_slice(s_idx, (bnd[b],), (W,)), (dest[b],))
    return k0B, k1B, idxB


def _chunk_boundaries(s_k0, e0, m_real, NB: int):
    """Exact run starts of the NB bucket runs in a sorted chunk.

    Two-level structure replacing jnp.searchsorted (whose scan-based
    binary search cost most of the count pass it is meant to replace,
    on an earlier accelerator): a stride-32 subsample compare gives every
    edge's
    position to within 32, then one fused 32-wide window compare
    finishes exactly. PAD_KEY tail entries exceed every edge, so they
    never perturb the counts; ``m_real`` caps the last run.

    Returns bnd int32[NB]: run b occupies [bnd[b], bnd[b] + len_b) with
    len_b = bnd[b+1] - bnd[b] (len_{NB-1} = m_real - bnd[NB-1]).
    """
    L = s_k0.shape[0]
    stride = 32
    sub = lax.slice(s_k0, (0,), (L,), (stride,))          # ceil(L/32)
    # coarse[e] = #(sub < e) -> window start (coarse-1)*32 covers the edge.
    coarse = jnp.sum((sub[None, :] < e0[:, None]).astype(jnp.int32),
                     axis=1)
    start = jnp.maximum(coarse - 1, 0) * stride
    win = s_k0[jnp.minimum(
        start[:, None] + lax.iota(jnp.int32, stride)[None, :], L - 1)]
    fine = jnp.sum((win < e0[:, None]).astype(jnp.int32), axis=1)
    pos = jnp.minimum(start + fine, m_real)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), pos])


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4, 16),
                   donate_argnums=(5, 6, 7, 8))
def _scatter_chunk_cf(m: int, spw: int, bits: int, W: int, NB: int,
                      k0B, k1B, idxB, fill, text_pad, vals, e0, base,
                      start, n, ranges=None, minpad: bool = False):
    """Count-free ``_scatter_chunk``: no precomputed counts needed.

    The chunk is sorted as usual; its run boundaries come from an exact
    in-program boundary search on the sorted keys (``_chunk_boundaries``)
    and each run's destination from ``base[b] + fill[b]``, where ``fill``
    is the device-resident running vector (NB fills + a trailing
    max-run-length cell) threaded through the chunk sequence. This
    deletes the standalone count pass: the slab layout ``base`` comes from the quantile-edge
    expectation (every bucket targets n/NB elements) plus a margin; a
    bucket overflowing its capacity — or a run overflowing the W window
    — is detected from the final fill vector and the build re-runs on
    the exact two-pass path (see execute_big). k0-only edges ONLY
    (bucket id is a function of k0; pair-edge plans keep the two-pass
    path).

    Returns the updated slabs and fill vector.
    """
    k0, k1 = _chunk_codes(m, spw, bits, text_pad, vals, start, n,
                          ranges=ranges, minpad=minpad)
    pos = start + lax.iota(jnp.int32, m)
    ok = pos < n
    k0 = jnp.where(ok, k0, PAD_KEY)
    k1 = jnp.where(ok, k1, PAD_KEY)
    padk = jnp.full((W,), PAD_KEY, jnp.int32)
    s_k0, s_k1, s_idx = lax.sort(
        (jnp.concatenate([k0, padk]), jnp.concatenate([k1, padk]),
         jnp.concatenate([pos, padk])),
        num_keys=1, is_stable=False)
    m_real = jnp.clip(n - start, 0, m)
    bnd = _chunk_boundaries(s_k0, e0, m_real, NB)
    counts = jnp.concatenate([bnd[1:], m_real[None]]) - bnd
    dest = base + fill[:NB]
    # Same fence as _scatter_chunk (see its comment): keep the window
    # slices out of the sort's output copies.
    s_k0, s_k1, s_idx = lax.optimization_barrier((s_k0, s_k1, s_idx))
    for b in range(NB):
        k0B = lax.dynamic_update_slice(
            k0B, lax.dynamic_slice(s_k0, (bnd[b],), (W,)), (dest[b],))
        k1B = lax.dynamic_update_slice(
            k1B, lax.dynamic_slice(s_k1, (bnd[b],), (W,)), (dest[b],))
        idxB = lax.dynamic_update_slice(
            idxB, lax.dynamic_slice(s_idx, (bnd[b],), (W,)), (dest[b],))
    new_fill = jnp.concatenate(
        [fill[:NB] + counts, jnp.maximum(fill[NB:], jnp.max(counts)[None])])
    return k0B, k1B, idxB, new_fill


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3, 4))
def _bucket_sort(S: int, desc_idx: bool, want_lcp: bool, spw: int,
                 bits: int, k0B, k1B, idxB, base, n_b, n,
                 prev_k0, prev_k1):
    """Sort one contiguous bucket (reads slabs, writes nothing).

    Returns (sorted idx, tie flags int32, tie count, max tie delta,
    delta-uniformity flag, lcp int32[S], last sorted k0, last k1).
    Pads (iota >= n_b) get PAD keys and sort to the end, so the first
    n_b outputs are the bucket's true order.

    ``want_lcp``: the carried keys hold each suffix's first 2*spw
    symbols, so the adjacent first-mismatch (xor + count-leading-zeros
    per word — the sorted-fetch LCP trick, core/lcp_window.py) yields
    lcp[j] = LCP(sa[j-1], sa[j]) exactly for every non-tied pair.
    ``prev_k0/prev_k1`` are the PREVIOUS live bucket's last sorted keys
    (-1 before the first bucket: its all-bits xor lands above the packed
    payload, clamping row 0 to the contract value lcp[0] = 0). Tied
    pairs: in chain mode lcp = n - prev_idx exactly (consecutive chain
    members, the lcp_window chain rule); ascending mode leaves the
    2*spw lower bound for the host residue pass to overwrite.

    Under minpad packing (packing_from_sigma) the key-derived values
    here can OVERSHOOT the true LCP for pairs where the shorter suffix
    ends inside the window and continues as min-symbol pads; the caller
    applies the final shorter-suffix-length clamp (``_clamp_lcp``) over
    the assembled arrays, where the post-residue indices are exact.
    """
    big = jnp.int32(1) << 30
    iota = lax.iota(jnp.int32, S)
    ok = iota < n_b
    k0 = jnp.where(ok, lax.dynamic_slice(k0B, (base,), (S,)), PAD_KEY)
    k1 = jnp.where(ok, lax.dynamic_slice(k1B, (base,), (S,)), PAD_KEY)
    idx = lax.dynamic_slice(idxB, (base,), (S,))
    tb = jnp.where(ok, (n - idx) if desc_idx else idx, big)
    # Chain mode (desc) NEEDS tb as a key: tied chain members must come
    # out in descending-index order. Ascending mode does not — every
    # tied group is reordered exactly by the host residue pass, which is
    # order-independent (_resolve_residue_host), so tb rides as payload
    # and the comparator drops a key. Neither needs stability (the key
    # tuple incl. tb is fully distinct in chain mode; ascending tie
    # order is don't-care); unstable 2-key was the cheapest sort on an
    # earlier accelerator (not re-measured on the GPU).
    sk0, sk1, st = lax.sort((k0, k1, tb), num_keys=3 if desc_idx else 2,
                            is_stable=False)
    # No post-sort fence here: unlike _scatter_chunk's window writes,
    # these consumers are elementwise and an optimization_barrier
    # measured neutral.
    s_idx = (n - st) if desc_idx else st
    real = iota < n_b                         # valid sorted first
    tie = (sk0 == jnp.concatenate([sk0[:1], sk0[:-1]])) & \
          (sk1 == jnp.concatenate([sk1[:1], sk1[:-1]])) & real
    tie = tie.at[0].set(False)
    prev_idx = jnp.concatenate([s_idx[:1], s_idx[:-1]])
    delta = jnp.where(tie, (prev_idx - s_idx) if desc_idx
                      else (s_idx - prev_idx), 0)
    dmax = jnp.max(jnp.where(tie, delta, 0))
    dmin = jnp.min(jnp.where(tie, delta, big))
    delta_ok = (~jnp.any(tie)) | ((dmin == dmax) & (dmax >= 1))
    if want_lcp:
        depth = jnp.int32(2 * spw)
        pk0 = jnp.concatenate([prev_k0.reshape(1), sk0[:-1]])
        pk1 = jnp.concatenate([prev_k1.reshape(1), sk1[:-1]])
        x0, x1 = pk0 ^ sk0, pk1 ^ sk1
        # Highest set xor bit p => first differing symbol spw-1 - p//bits
        # (symbols pack first-highest). Real keys are < 2^30 with zero
        # bits above spw*bits, so sym >= 0 for them; the -1 sentinel row
        # mismatches at bit 31, goes negative, and clamps to 0.
        off0 = jnp.where(x0 != 0,
                         spw - 1 - (31 - lax.clz(x0)) // bits, depth)
        off1 = jnp.where(x1 != 0,
                         2 * spw - 1 - (31 - lax.clz(x1)) // bits, depth)
        lcp = jnp.maximum(jnp.where(x0 != 0, off0, off1), 0)
        if desc_idx:
            lcp = jnp.where(tie, n - prev_idx, lcp)
        lcp32 = jnp.where(real, lcp, 0).astype(jnp.int32)
        last_k0 = lax.dynamic_slice(sk0, (n_b - 1,), (1,))[0]
        last_k1 = lax.dynamic_slice(sk1, (n_b - 1,), (1,))[0]
    else:
        lcp32 = jnp.zeros((1,), jnp.int32)
        last_k0 = last_k1 = jnp.int32(-1)
    return (s_idx, tie.astype(jnp.int32), jnp.sum(tie.astype(jnp.int32)),
            dmax, delta_ok.astype(jnp.int32), lcp32, last_k0, last_k1)


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1, 2))
def _bucket_write(S: int, idxB, k1B, s_idx, tie32, out_base):
    """Write one bucket's sorted order + tie flags at its final offset.

    idxB receives the compact SA block at out_base (back-to-back with
    its neighbors — after the last bucket idxB[:n] IS the suffix array);
    k1B's dead key storage receives the aligned tie flags. ZERO reads of
    the donated operands, so aliasing is structurally copy-free.
    """
    return (lax.dynamic_update_slice(idxB, s_idx, (out_base,)),
            lax.dynamic_update_slice(k1B, tie32, (out_base,)))


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1, 2, 3))
def _bucket_write_lcp(S: int, idxB, k1B, k0B, s_idx, tie32, lcp32,
                      out_base):
    """``_bucket_write`` + the bucket's lcp column into k0B's dead key
    storage. Same geometry invariant (out_base[b] + S_b <= base[b+1]),
    so the lcp writes never touch a not-yet-read key region; after the
    last bucket k0B[:n] IS the LCP array, aligned to idxB[:n]."""
    return (lax.dynamic_update_slice(idxB, s_idx, (out_base,)),
            lax.dynamic_update_slice(k1B, tie32, (out_base,)),
            lax.dynamic_update_slice(k0B, lcp32, (out_base,)))


@functools.partial(jax.jit, static_argnums=(0,))
def _extract_ties(S: int, flagB, idxB, out_base, n_b):
    """Compact one bucket's tied elements to (global SA slot, idx) pairs.

    Reads the final order (idxB) and its flags (k1B storage after
    ``_bucket_write``). A tie GROUP contributes all its members (the
    flag marks the later element of each tied pair; heads join via the
    successor's flag). Returns fixed RESIDUE_SLOTS pairs (-1-padded
    slots) + the true member count.
    """
    big = jnp.int32(1) << 30
    j = lax.iota(jnp.int32, S)
    ok = j < n_b
    f = jnp.where(ok, lax.dynamic_slice(flagB, (out_base,), (S,)), 0)
    ix = jnp.where(ok, lax.dynamic_slice(idxB, (out_base,), (S,)), 0)
    tied = f > 0
    member = (tied | jnp.concatenate([tied[1:], tied[:1]])) & ok
    keyed = jnp.where(member, j, big)
    o_slot, o_idx = lax.sort((keyed, ix), num_keys=1)
    k = min(RESIDUE_SLOTS, S)
    out_slot = jnp.where(o_slot[:k] < big, out_base + o_slot[:k], -1)
    return out_slot, o_idx[:k], jnp.sum(member.astype(jnp.int32))


@functools.partial(jax.jit, donate_argnums=(0,))
def _apply_patch(sa, slots, vals):
    """Scatter host-resolved residue orderings back into the SA.

    Pad slots (-1) are routed OUT OF RANGE and dropped: the previous
    form clamped them to slot 0 and wrote back its pre-scatter value,
    which duplicates slot 0 as a scatter index — XLA's ordering for
    duplicate-index set() is undefined, and when a REAL patch also
    targets slot 0 (the text's two smallest suffixes window-tied) the
    stale write could win (soak-found r3: sa[0] kept the unpatched
    value; one-in-a-permutation corruption)."""
    n = sa.shape[0]
    tgt = jnp.where(slots >= 0, slots, n)
    return sa.at[tgt].set(vals, mode="drop")


@functools.partial(jax.jit, donate_argnums=(1,))
def _clamp_lcp(sa, lcp, n):
    """Final shorter-suffix-length clamp over the assembled arrays.

    Under minpad packing (packing_from_sigma) a suffix ending inside the
    carried window continues as min-symbol pads, so a pair's first CODE
    mismatch — the _bucket_sort key-derived lcp — can land past the
    shorter suffix's true end. true_lcp = min(first real mismatch,
    len_a, len_b), and the codes are order-isomorphic to the bytes up to
    the shorter length, so min(key_lcp, n - max(sa[j-1], sa[j])) is
    exact. Runs over the FINAL sa (post residue patch): the key xor of
    a tie group's edge pairs is invariant under the group's reorder, but
    the clamp operand is whichever member landed at the edge. Host-
    patched and chain-rule values are already <= both suffix lengths, so
    the clamp never disturbs them. Row 0 pairs with itself:
    lcp[0] = 0 stays 0.
    """
    prev = jnp.concatenate([sa[:1], sa[:-1]])
    return jnp.minimum(lcp, n - jnp.maximum(prev, sa))


@jax.jit
def _period_mismatches(text_pad, d, n):
    """#positions t in [0, n-d) with text[t] != text[t+d] (d traced)."""
    L = text_pad.shape[0]
    shifted = lax.dynamic_slice(
        jnp.concatenate([text_pad, jnp.zeros_like(text_pad)]), (d,), (L,))
    t = lax.iota(jnp.int32, L)
    bad = (text_pad != shifted) & (t < n - d)
    return jnp.sum(bad.astype(jnp.int32))


def estimate_repeat_len(arr: np.ndarray, sample: int = 1 << 16,
                        probe_depth: int = 4096, seed: int = 0x11
                        ) -> int:
    """Cheap host-side estimate of the text's longest repeat (bytes).

    Samples positions, finds 8-byte-window collisions among them, and
    extends a few hundred colliding pairs by direct comparison. Periodic
    texts (every sample collides, repeats ~n) score huge; random text
    scores ~log n. Used to route repetitive mid-size texts to the chain
    machinery before the doubling loop burns log2(n) rounds on them.
    """
    n = len(arr)
    if n < 64:
        return 0
    rng = np.random.default_rng(seed)
    pos = rng.integers(0, n - 9, min(sample, n))
    win = np.zeros(len(pos), np.uint64)
    for j in range(8):
        win = (win << np.uint64(8)) | arr[pos + j].astype(np.uint64)
    order = np.argsort(win, kind="stable")
    ws, ps = win[order], pos[order]
    coll = np.flatnonzero((ws[1:] == ws[:-1]) & (ps[1:] != ps[:-1]))[:256]
    best = 8 if len(coll) else 0
    for c in coll:
        a, b = int(ps[c]), int(ps[c + 1])
        lim = min(probe_depth, n - max(a, b))
        wa, wb = arr[a:a + lim], arr[b:b + lim]
        neq = np.flatnonzero(wa != wb)
        best = max(best, int(neq[0]) if len(neq) else lim)
    return best


def carried_depth_syms(sigma: int) -> int:
    """Symbols resolved by the carried keys (2 words)."""
    return 2 * packing_from_sigma(sigma)[1]


# Repeat-estimate threshold for "route a mid-size text to the carried
# keys machinery": 3 words x max spw-per-word bound (~16) — repeats
# deeper than any one-pass window mean the doubling loop would burn
# log2(repeat) rounds that chain/residue/refinement machinery avoids.
# Shared by the single-device and sharded routers (a previous inline
# copy of a routing gate drifted once).
DEEP_REPEAT_EST = 3 * 16


def deep_repeat_class(est_repeat: int) -> bool:
    """Mid-size routing gate: repeats beyond every one-pass window."""
    return est_repeat > DEEP_REPEAT_EST


def chain_plausible(est_repeat: int, n: int) -> bool:
    """Is the text plausibly GLOBALLY periodic (chain-mode material)?

    ``estimate_repeat_len`` extends sampled colliding pairs up to its
    4096-byte probe depth; on any globally periodic text the extension
    runs through whole periods, so the estimate saturates near the
    probe cap whenever n is large enough.  Texts with merely *long*
    repeats (natural language, code, logs — repeated phrases of
    50-1000 bytes) score well below it.  The previous gate
    (est > 2*spw, i.e. "any repeat beyond the carried window") sent
    every heavy-duplication text into a chain build that then failed
    its period verification and re-ran — one full wasted pass per
    build once refinement made those texts buildable (r5)."""
    import os

    thresh = min(int(os.environ.get("SA_CHAIN_EST_MIN", 3072)),
                 max(n // 4, 1))
    return est_repeat >= thresh


def chunk_geometry(n: int, chunk_elems: int | None = None
                   ) -> tuple[int, int, int]:
    """(m, n_chunks, padded_text_len) for an n-byte bigsort.

    Exposed so callers that already hold a device-resident text (e.g.
    bench.py's twin-generated corpus) can size it to the exact padded
    shape ``prepare_big`` expects and skip staging entirely.
    """
    if chunk_elems is None:
        # Everything routed to the MSD as the PREFERRED path (above
        # SA_DIRECT_CROSS, 2^27 — see prefer_direct) gets 7*2^20
        # chunks: a bitonic sort's cost STEPS at powers of two, and the
        # scatter sorts m + W elements — m = 7*2^20 keeps m + W under
        # 2^23. This geometry was tuned on an earlier accelerator; the
        # GPU's sorts are not bitonic networks, so it is to be
        # re-derived there (ROADMAP item 3). Below the cross (MSD runs
        # only as a fallback there), keep fewer/larger chunks.
        chunk_elems = int(os.environ.get(
            "SA_CHUNK_ELEMS", 7 << 20 if n > 1 << 26 else 1 << 25))
    m = bucket_size(min(chunk_elems, n))
    n_chunks = -(-n // m)
    return m, n_chunks, n_chunks * m + HALO


def prepare_big(text, *, target_bucket: int | None = None,
                chunk_elems: int | None = None, sample: int = 1 << 21,
                text_dev=None, remap: np.ndarray | None = None,
                est_repeat: int | None = None):
    """Stage the text on device and build the host plan (untimed setup).

    ``text_dev``: optional pre-staged device copy of the text, padded to
    ``chunk_geometry(n, chunk_elems)[2]`` with zeros past n (skips the
    host->device transfer; the host ``text`` must hold the same bytes —
    it feeds edge sampling and residue resolution).

    ``remap``/``est_repeat``: precomputed planning products for the same
    bytes (alphabet_remap table / estimate_repeat_len) — routers that
    already scanned the text to pick this path pass them to skip the
    re-scan (a full-text pass each, ~0.6 s/2^28 on this host).
    """
    arr = as_byte_array(text)
    n = int(arr.shape[0])
    if n < 8:
        raise ValueError("bigsort needs n >= 8; use build_suffix_array")
    if target_bucket is None:
        # Just UNDER 2^23 on purpose: quantile edges target n/NB
        # elements per bucket, and 8 060 000 (+ the ~1 % sampling error)
        # keeps every bucket fill below 2^23, so every bucket sort runs
        # in the at-or-below-2^23 network class. Planning AT 2^23 put
        # half the fills just past the power of two, where a bitonic
        # sort steps to the next class (an earlier accelerator's
        # finding; to be re-derived on the GPU, ROADMAP item 3).
        target_bucket = int(os.environ.get("SA_TARGET_BUCKET", 8_060_000))
    m, n_chunks, pad_len = chunk_geometry(n, chunk_elems)
    if remap is None:
        remap, _, _ = alphabet_remap(arr)
    bits, spw, minpad = packing_mode(remap)
    e0, e1, fill_frac = sample_edges(arr, remap, spw, bits, target_bucket,
                                     sample=sample, with_fracs=True,
                                     minpad=minpad)
    if text_dev is None:
        from hpc_suffix_array_tpu.utils.staging import stage_to_device

        host = np.zeros(pad_len, np.uint8)
        host[:n] = arr
        text_dev = stage_to_device(host)
    elif tuple(text_dev.shape) != (pad_len,):
        raise ValueError(
            f"text_dev shape {text_dev.shape} != padded ({pad_len},); "
            "size it with chunk_geometry(n, chunk_elems)")
    return {
        "plan": BigPlan(n=n, m=m, n_chunks=n_chunks, bits=bits, spw=spw,
                        remap=remap, e0=e0, e1=e1, minpad=minpad,
                        meta={"est_repeat": (estimate_repeat_len(arr)
                                             if est_repeat is None
                                             else est_repeat),
                              "target_bucket": target_bucket,
                              "fill_frac": fill_frac}),
        "text_pad": text_dev,
        # Device remap inputs: static byte ranges when the alphabet is
        # piecewise contiguous, else present values for the compare-sum
        # (the host-side quantile sampling still uses the remap table).
        "ranges": byte_ranges(remap),
        "vals_d": jnp.asarray(np.flatnonzero(remap > 0).astype(np.uint8)),
        "host_text": arr,
    }


def _suffix_less(arr: np.ndarray, a: int, b: int, n: int,
                 step: int = 4096) -> bool:
    """Exact suffix comparison by bounded windows (host)."""
    off = 0
    while True:
        la, lb = n - a - off, n - b - off
        L = min(la, lb, step)
        if L <= 0:
            return la < lb          # equal through the shorter's end
        wa = arr[a + off:a + off + L]
        wb = arr[b + off:b + off + L]
        neq = np.flatnonzero(wa != wb)
        if len(neq):
            t = int(neq[0])
            return bool(wa[t] < wb[t])
        if L < step:
            return la < lb
        off += L


def _suffix_lcp(arr: np.ndarray, a: int, b: int, n: int,
                step: int = 4096) -> int:
    """Exact LCP of suffixes a and b by bounded windows (host)."""
    off = 0
    while True:
        L = min(n - a - off, n - b - off, step)
        if L <= 0:
            return n - max(a, b)        # one is a prefix of the other
        neq = np.flatnonzero(arr[a + off:a + off + L]
                             != arr[b + off:b + off + L])
        if len(neq):
            return off + int(neq[0])
        if L < step:
            return n - max(a, b)
        off += L


RESIDUE_WIN = 64     # bytes compared vectorized before the exact fallback


class ResidueDepthError(Exception):
    """A residue tie is undecided within a bounded-window text view.

    Raised only by views that cannot read the whole text (the
    multi-process _GatheredView in parallel/bigsort.py); callers fall
    back to the doubling builder, which resolves any tie depth."""


class _ArrView:
    """Whole-text accessor for residue resolution (single process).

    The view contract (shared with parallel/bigsort._GatheredView):
      fetch(idxs, K) -> int16[len(idxs), K] suffix windows, -1 past the
        end of the text (so a shorter suffix that is a prefix orders
        first — the strcmp semantics of the reference,
        manber_myers.c:195);
      suffix_less(a, b) / suffix_lcp(a, b): exact order / lcp for the
        rare pairs equal through the whole RESIDUE_WIN window.
    """

    def __init__(self, arr: np.ndarray, n: int):
        self.arr, self.n = arr, n

    def fetch(self, idxs: np.ndarray, K: int) -> np.ndarray:
        pos = idxs.astype(np.int64)[:, None] + np.arange(K, dtype=np.int64)
        return np.where(pos < self.n,
                        self.arr[np.minimum(pos, self.n - 1)
                                 ].astype(np.int16),
                        np.int16(-1))

    def suffix_less(self, a: int, b: int) -> bool:
        return _suffix_less(self.arr, a, b, self.n)

    def suffix_lcp(self, a: int, b: int) -> int:
        return _suffix_lcp(self.arr, a, b, self.n)


def _resolve_residue_host(arr, slots: np.ndarray,
                          idxs: np.ndarray, n: int, want_lcp: bool = False):
    """Exact order for one bucket's tied elements (host comparison).

    Groups are runs of CONSECUTIVE slots; order within each group =
    full suffix order. Returns (ascending slots, idx aligned to them,
    lcp-patch slots, lcp-patch values). The lcp patches cover every
    group-INTERNAL adjacent pair — exactly the tied pairs, whose
    carried-key lcp is only the 2*spw lower bound. Group-boundary pairs
    need no patch: all members share identical key words, so the
    key-derived lcp of the pair at the group's edge is invariant under
    the reordering — exact under reserved-0 packing; under minpad
    packing it may overshoot the shorter suffix's length and is made
    exact only by the final _clamp_lcp pass, which every build path
    applies AFTER this patch (do not remove or reorder that clamp).

    Vectorized: one RESIDUE_WIN-byte window fetch per member (past-end
    as -1, so a shorter suffix that is a prefix orders first — the
    strcmp semantics of the reference, manber_myers.c:195), np.lexsort
    within groups, and a bounded exact-comparison fallback for the rare
    pairs equal through the whole window (a per-pair Python loop here
    measured ~1.5 s on 65k tied pairs, DNA 2^28).

    ``arr`` is either the host text (np.uint8[n]) or a text VIEW
    implementing the _ArrView contract — the multi-process build passes
    a view backed by device window gathers, so no process ever needs
    the whole text."""
    view = arr if hasattr(arr, "fetch") else _ArrView(arr, n)
    order = np.argsort(slots, kind="stable")
    slots, idxs = slots[order], idxs[order]
    P = len(slots)
    if P == 0:
        return slots, idxs, np.zeros(0, np.int64), np.zeros(0, np.int32)
    gid = np.cumsum(np.r_[np.int64(0),
                          (np.diff(slots) != 1).astype(np.int64)])
    K = RESIDUE_WIN
    win = view.fetch(idxs, K)
    valid = win >= 0
    # lexsort: last key is primary -> (gid, win[:,0], ..., win[:,K-1]).
    o2 = np.lexsort([win[:, k] for k in range(K - 1, -1, -1)] + [gid])
    out = idxs[o2]
    win_s, valid_s, gid_s = win[o2], valid[o2], gid[o2]
    same_g = gid_s[1:] == gid_s[:-1]
    eq_win = (win_s[1:] == win_s[:-1]).all(axis=1)
    # Pairs equal through the full window with both suffixes extending
    # past it are undecided by the lexsort: fix their runs exactly.
    undecided = same_g & eq_win & valid_s[1:, K - 1] & valid_s[:-1, K - 1]
    if undecided.any():
        run_edges = np.flatnonzero(np.diff(
            np.r_[False, undecided, False].astype(np.int8)))
        if hasattr(view, "prefetch"):
            # Window-backed views batch ONE deep gather for all
            # undecided members instead of a device call per compare.
            members = sorted({int(out[j])
                              for lo, hi in zip(run_edges[::2],
                                                run_edges[1::2])
                              for j in range(lo, hi + 1)})
            view.prefetch(members)
        for lo, hi in zip(run_edges[::2], run_edges[1::2]):
            seg = out[lo:hi + 1].tolist()      # undecided run + its tail
            seg.sort(key=functools.cmp_to_key(
                lambda a, b: -1 if view.suffix_less(a, b) else 1))
            out[lo:hi + 1] = seg
    if not want_lcp:
        return slots, out, np.zeros(0, np.int64), np.zeros(0, np.int32)
    # LCP for every group-internal adjacent pair of the FINAL order.
    win = view.fetch(out, K)
    neq = win[1:] != win[:-1]
    has_mm = neq.any(axis=1)
    first_mm = np.argmax(neq, axis=1)
    # No mismatch in-window: either one suffix ended inside (lcp = its
    # length) or both extend (exact fallback below).
    shorter = np.minimum(n - out[1:].astype(np.int64),
                         n - out[:-1].astype(np.int64))
    lv = np.where(has_mm, first_mm, np.minimum(shorter, K)).astype(np.int64)
    internal = np.flatnonzero(same_g)
    lslots = slots[internal + 1].astype(np.int64)
    lvals = lv[internal]
    deep = internal[(~has_mm[internal]) & (shorter[internal] > K)]
    if len(deep) and hasattr(view, "prefetch"):
        view.prefetch(sorted({int(out[j]) for j in deep}
                             | {int(out[j + 1]) for j in deep}))
    for j in deep:
        lvals[np.searchsorted(internal, j)] = view.suffix_lcp(
            int(out[j]), int(out[j + 1]))
    return slots, out, lslots, lvals.astype(np.int32)


def _apply_residue(sa, lcp, arr, patches, n: int, want_lcp: bool):
    """Resolve host residue pairs and patch them into sa (and lcp).

    ``patches``: list of (slots int64[], idxs int32[]) per extraction.
    Returns (sa, lcp, n_patched)."""
    all_slots, all_vals = [], []
    lcp_slots, lcp_vals = [], []
    for slots, idxs in patches:
        if not len(slots):
            continue
        s_sorted, fixed, ls, lv = _resolve_residue_host(
            arr, slots, idxs, n, want_lcp=want_lcp)
        all_slots.append(s_sorted.astype(np.int64))
        all_vals.append(fixed)
        lcp_slots.append(ls)
        lcp_vals.append(lv)

    def _patch(target, slot_parts, val_parts):
        slots = np.concatenate(slot_parts)
        vals = np.concatenate(val_parts)
        if not len(slots):
            return target
        k = bucket_size(len(slots))
        ps = np.full(k, -1, np.int32)
        pv = np.zeros(k, np.int32)
        ps[:len(slots)] = slots
        pv[:len(slots)] = vals
        return _apply_patch(target, jnp.asarray(ps), jnp.asarray(pv))

    n_patched = 0
    if all_slots:
        sa = _patch(sa, all_slots, all_vals)
        n_patched = int(sum(len(s) for s in all_slots))
    if want_lcp and lcp_slots:
        lcp = _patch(lcp, lcp_slots, lcp_vals)
    return sa, lcp, n_patched


def execute_big(state, *, max_bucket_elems: int | None = None,
                force_chain_mode: bool | None = None,
                want_lcp: bool = False,
                count_free: bool | None = None) -> jnp.ndarray:
    """Run scatter + bucket passes (+ count pass when not count-free);
    returns the SA (device int32[n]).

    Chain mode (descending tiebreak for globally periodic texts) is
    chosen up front from the host repeat estimate — the compact output
    write consumes the slabs, so the direction cannot be switched after
    the fact without redistributing (the misprediction fallbacks below
    do exactly that, once).

    ``want_lcp``: also derive the LCP array from the carried sort keys
    (adjacent xor+clz in the bucket pass, chain rule / host residue for
    the bounded ties — see ``_bucket_sort``) and return ``(sa, lcp)``.
    The reference contract always measures LCP_TIME alongside the build
    (src/sequential/main_sequential.c:41-49); at 1 GiB this is the only
    path — a standalone full-text sort for LCP would cost as much as
    the build itself.

    ``count_free`` (default: auto, k0-only plans): skip the standalone
    count pass — slab layout from the quantile-edge expectation, exact
    run boundaries searched in-program on each sorted chunk, dest
    offsets from a device-resident running fill vector
    (``_scatter_chunk_cf``). Overflowing the estimated capacity re-runs
    on the exact two-pass path once (recorded in
    ``plan.meta["rerun"]``, like the chain-direction mispredictions).
    """
    plan: BigPlan = state["plan"]
    text_pad = state["text_pad"]
    vals_d = state["vals_d"]
    ranges = state.get("ranges")
    n, m, C = plan.n, plan.m, plan.n_chunks
    e0 = jnp.asarray(plan.e0)
    e1 = jnp.asarray(plan.e1)
    NB = plan.n_buckets
    _stamps = [("start", time.perf_counter())]

    chain_mode = force_chain_mode
    if chain_mode is None:
        chain_mode = chain_plausible(plan.meta.get("est_repeat", 0), n)
    k0_only = not bool(plan.e1.any())
    if count_free is None:
        count_free = (k0_only and NB >= 2 and
                      os.environ.get("SA_BIG_COUNT_FREE", "1") == "1")

    pass_cap = max_bucket_elems or MAX_PASS_ELEMS
    if count_free:
        # --- count-free: estimated layout + one-pass scatter -----------
        # Quantile edges target n/NB elements per bucket and m/NB per
        # run; the margin covers the sampler's quantile error (rel sigma
        # = sqrt(NB/sample) ~ 0.8 % at the 1 GiB geometry — 6 % is >7
        # sigma). Genuinely skewed texts (heavy k0 values, merged
        # quantile edges) overflow the capacity or the W window and
        # re-run on the exact two-pass path below (meta["rerun"]).
        # Geometry invariants as in the exact branch, with fills
        # replaced by their cap: S_b <= bucket_size(cap_fill) and
        # sum fills[<b] <= b*cap_fill, so G_0 >= bucket_size(cap)-cap
        # keeps every compact write inside the gaps.
        margin = float(os.environ.get("SA_CF_MARGIN", "0.06"))
        frac = plan.meta.get("fill_frac")
        if frac is None or len(frac) != NB:
            frac = np.full(NB, 1.0 / NB)
        caps = (frac * n * (1 + margin)).astype(np.int64) + 256
        W = int(bucket_size(int(frac.max() * m * (1 + margin)) + 256))
        slack = max(int(bucket_size(int(c))) - int(c) for c in caps)
        g0 = max(W, slack + 64)
        base = np.zeros(NB + 1, np.int64)
        for b in range(NB):
            base[b + 1] = base[b] + int(caps[b]) + (g0 if b == 0 else W)
        slab_len = max(int(base[NB]),
                       max(int(base[b]) + int(bucket_size(int(caps[b])))
                           for b in range(NB)))

        idxB = jnp.zeros((slab_len,), jnp.int32)
        k0B = jnp.zeros((slab_len,), jnp.int32)
        k1B = jnp.zeros((slab_len,), jnp.int32)
        fill_d = jnp.zeros((NB + 1,), jnp.int32)
        base_d = jnp.asarray(base[:NB].astype(np.int32))
        for c in range(C):
            k0B, k1B, idxB, fill_d = _scatter_chunk_cf(
                m, plan.spw, plan.bits, W, NB, k0B, k1B, idxB, fill_d,
                text_pad, vals_d, e0, base_d, jnp.int32(c * m),
                jnp.int32(n), ranges, plan.minpad)
        fill_w = np.asarray(jax.device_get(fill_d)).astype(np.int64)
        fills, max_run = fill_w[:NB], int(fill_w[NB])
        assert fills.sum() == n, (fills.sum(), n)     # boundary-search inv.
        plan.counts = None
        _stamps.append(("scatter", time.perf_counter()))
        if max_run > W or (fills > caps).any():
            del idxB, k0B, k1B, fill_d      # free before re-running
            plan.meta.setdefault("rerun", []).append("count_free_overflow")
            return execute_big(state, max_bucket_elems=max_bucket_elems,
                               force_chain_mode=force_chain_mode,
                               want_lcp=want_lcp, count_free=False)
    else:
        # --- pass A: count ----------------------------------------------
        cnt_ge = np.asarray(jax.device_get(_count_chunks(
            C, m, plan.spw, plan.bits, text_pad, vals_d, e0, e1,
            jnp.int32(n), ranges, k0_only,
            plan.minpad))).astype(np.int64)                      # (C, E)
        real = np.minimum(m, np.maximum(0, n - np.arange(C) * m))
        full = np.concatenate(
            [real[:, None], cnt_ge, np.zeros((C, 1), np.int64)], axis=1)
        counts = full[:, :-1] - full[:, 1:]                      # (C, NB)
        plan.counts = counts
        fills = counts.sum(axis=0)
        assert fills.sum() == n, (fills.sum(), n)
        _stamps.append(("count", time.perf_counter()))

        # --- host layout -------------------------------------------------
        # Geometry invariants (all writes are unmasked fixed-width):
        #   scatter run write:  dest[c][b] + W  <= base[b+1]   (G_b >= W)
        #   compact out write:  out_base[b] + S_b <= base[b+1]
        #       <=> S_b - fills[b] <= sum_{b'<=b} G_b'  (G_0 >= max slack)
        W = int(bucket_size(int(counts.max())))
        S_pre = {b: bucket_size(int(fills[b]))
                 for b in range(NB) if fills[b]}
        if S_pre and max(S_pre.values()) > pass_cap:
            raise NotImplementedError(
                f"bucket skew: one bucket holds {int(fills.max())} of "
                f"n={n} elements; the text's prefix distribution is too "
                "degenerate for the out-of-core path - use the doubling "
                "kernel (<=256 MB) or the sharded multi-chip build")
        slack = max((S_pre[b] - int(fills[b]) for b in S_pre), default=0)
        gaps = [max(W, slack)] + [W] * (NB - 1)
        base = np.zeros(NB + 1, np.int64)
        acc = 0
        for b in range(NB):
            base[b] = acc
            acc += int(fills[b]) + gaps[b]
        base[NB] = acc
        slab_len = max(int(acc),
                       max((int(base[b]) + S_pre[b] for b in S_pre),
                           default=0))
        dest = base[None, :NB] + np.concatenate(
            [np.zeros((1, NB), np.int64),
             counts.cumsum(axis=0)[:-1]])                        # (C, NB)

        # --- pass B: scatter into bucket-major slabs ----------------------
        idxB = jnp.zeros((slab_len,), jnp.int32)
        k0B = jnp.zeros((slab_len,), jnp.int32)
        k1B = jnp.zeros((slab_len,), jnp.int32)
        bnd = np.concatenate(
            [np.zeros((C, 1), np.int64), counts.cumsum(axis=1)[:, :-1]],
            axis=1)
        keys = 1 if k0_only else 2          # k0-only edges -> 1-key sort
        for c in range(C):
            k0B, k1B, idxB = _scatter_chunk(
                m, plan.spw, plan.bits, W, keys, k0B, k1B, idxB, text_pad,
                vals_d, jnp.asarray(dest[c].astype(np.int32)),
                jnp.asarray(bnd[c].astype(np.int32)),
                jnp.int32(c * m), jnp.int32(n), ranges, plan.minpad)
        _ = jax.device_get(idxB[0])                              # fence
        _stamps.append(("scatter", time.perf_counter()))

    # --- shared post-scatter layout (exact fills either way) -----------
    # Bucket shapes stay on the coarse bucket_size grid: a uniform
    # fine-grid S (fills cluster ±1 %, so one shape could serve every
    # bucket at ~2 % pad) regressed on an earlier accelerator, where
    # sort cost stepped at powers of two and the uniform shape pushed
    # half of the buckets out of the 2^23 class. The lever there was
    # planning max fill UNDER the power of two (SA_TARGET_BUCKET).
    live = [b for b in range(NB) if fills[b]]
    S_of = {b: bucket_size(int(fills[b])) for b in live}
    if live and max(S_of.values()) > pass_cap:
        raise NotImplementedError(
            f"bucket skew: one bucket holds {int(fills.max())} of n={n} "
            "elements; the text's prefix distribution is too degenerate "
            "for the out-of-core path - use the doubling kernel "
            "(<=256 MB) or the sharded multi-chip build")
    out_base = np.concatenate([[0], fills.cumsum()[:-1]]).astype(np.int64)
    for b in live:                           # compact-write invariant
        assert int(out_base[b]) + S_of[b] <= int(base[b + 1]), (b, n)

    # --- pass C: per-bucket sort + compact write ------------------------
    pend = []
    prev_k0 = prev_k1 = jnp.int32(-1)   # sentinel: clamps lcp[0] to 0
    for b in live:
        s_idx, tie32, ties, d, dok, lcp32, prev_k0, prev_k1 = _bucket_sort(
            S_of[b], chain_mode, want_lcp, plan.spw, plan.bits,
            k0B, k1B, idxB, jnp.int32(base[b]),
            jnp.int32(fills[b]), jnp.int32(n), prev_k0, prev_k1)
        if want_lcp:
            idxB, k1B, k0B = _bucket_write_lcp(
                S_of[b], idxB, k1B, k0B, s_idx, tie32, lcp32,
                jnp.int32(out_base[b]))
        else:
            idxB, k1B = _bucket_write(
                S_of[b], idxB, k1B, s_idx, tie32, jnp.int32(out_base[b]))
        pend.append((b, ties, d, dok))
    tie_counts = np.asarray(jax.device_get(
        jnp.stack([t for _, t, _, _ in pend])))              # ONE sync
    _stamps.append(("bucket_sorts", time.perf_counter()))

    verified: set[int] = set()
    if chain_mode:
        dvals = np.asarray(jax.device_get(
            jnp.stack([d for _, _, d, _ in pend])))
        doks = np.asarray(jax.device_get(
            jnp.stack([k for _, _, _, k in pend])))
        for (b, _, _, _), tc, d, dok in zip(pend, tie_counts, dvals, doks):
            if tc == 0:
                continue
            if not int(dok):
                if force_chain_mode is None:
                    # Irregular ties: chain mode was a misprediction.
                    # The ascending path resolves ANY tie mass (host
                    # residue below the caps, device refinement above).
                    del idxB, k0B, k1B      # free before re-running
                    plan.meta.setdefault("rerun", []).append(
                        "chain_to_ascending")
                    return execute_big(
                        state, max_bucket_elems=max_bucket_elems,
                        force_chain_mode=False, want_lcp=want_lcp)
                raise NotImplementedError(
                    f"bucket {b}: residual ties are not uniform arithmetic "
                    "chains - use the doubling kernel (<=256 MB) or the "
                    "sharded multi-chip build")
            d = int(d)
            if d and d not in verified:
                mm = int(jax.device_get(_period_mismatches(
                    text_pad, jnp.int32(d), jnp.int32(n))))
                if mm:
                    if force_chain_mode is None:
                        # Uniform deltas that are NOT a global period
                        # (e.g. one long repeated block): the ascending
                        # path handles any tie mass.
                        del idxB, k0B, k1B
                        plan.meta.setdefault("rerun", []).append(
                            "chain_to_ascending")
                        return execute_big(
                            state, max_bucket_elems=max_bucket_elems,
                            force_chain_mode=False, want_lcp=want_lcp)
                    raise NotImplementedError(
                        f"bucket {b}: chain delta {d} is not a global "
                        f"period ({mm} mismatches) - use the doubling "
                        "kernel (<=256 MB) or the sharded build")
                verified.add(d)
    elif (tie_counts.sum() > n // 4
          and chain_plausible(plan.meta.get("est_repeat", 0), n)
          and "chain_to_ascending" not in plan.meta.get("rerun", [])):
        # Misprediction (periodic-looking text ran ascending):
        # redistribute once in chain mode — the compact write already
        # consumed the slabs, so the passes must restart. Heavily tied
        # but aperiodic texts (natural language / code / logs) skip the
        # flip — their ties go to device refinement below — and a build
        # that already fell back FROM chain mode never flips again.
        del idxB, k0B, k1B                  # free before re-running
        plan.meta.setdefault("rerun", []).append("ascending_to_chain")
        return execute_big(state, max_bucket_elems=max_bucket_elems,
                           force_chain_mode=True, want_lcp=want_lcp)

    # --- residue extraction (slots are global SA positions) -------------
    # Enqueue every tied bucket's extraction, then fetch ONCE: a
    # per-bucket sync costs host round-trips per bucket, which dominated
    # heavy-residue corpora (DNA) before the fetch was batched.
    patches = []
    refine_mode = False
    # The host path's real bound is PER BUCKET (extraction fetches
    # RESIDUE_SLOTS members per bucket); members <= 2*flags + groups,
    # so flags*2 over the cap predicts an extraction overflow without
    # paying the round-trips. The global cap guards the pathological
    # many-bucket aggregate (the host lexsort is O(total * WIN)).
    host_cap = int(os.environ.get("SA_HOST_RESIDUE_MAX", 1 << 20))
    if not chain_mode and tie_counts.sum():
        if (int(tie_counts.max()) * 2 > RESIDUE_SLOTS
                or int(tie_counts.sum()) > host_cap):
            # Tie mass beyond the bounded host path: resolve on device
            # (core/refine.py) — no extraction round-trips needed.
            refine_mode = True
        else:
            pend_ex = []              # (bucket, k, slots_d, idx_d, tot_d)
            for (b, _, _, _), tc in zip(pend, tie_counts):
                if tc == 0:
                    continue
                slots_d, idx_d, total_d = _extract_ties(
                    S_of[b], k1B, idxB, jnp.int32(out_base[b]),
                    jnp.int32(fills[b]))
                pend_ex.append((b, min(RESIDUE_SLOTS, S_of[b]),
                                slots_d, idx_d, total_d))
            if pend_ex:
                totals = np.asarray(jax.device_get(
                    jnp.stack([t for _, _, _, _, t in pend_ex])))
                slots_all = np.asarray(jax.device_get(
                    jnp.concatenate([s for _, _, s, _, _ in pend_ex])))
                idx_all = np.asarray(jax.device_get(
                    jnp.concatenate([i for _, _, _, i, _ in pend_ex])))
                off = 0
                for (b, k, _, _, _), total in zip(pend_ex, totals):
                    total = int(total)
                    if total > RESIDUE_SLOTS:
                        # One bucket's members overflow the extraction
                        # cap: the device refinement pass has no such
                        # bound (pre-r5 this was a refusal).
                        refine_mode = True
                        patches = []
                        break
                    patches.append((b, slots_all[off:off + total],
                                    idx_all[off:off + total]))
                    off += k
    _stamps.append(("residue_extract", time.perf_counter()))

    # --- finish: idxB[:n] IS the SA (k0B[:n] the LCP); apply residue ----
    # Frees are sequenced so peak memory stays ~3 slab-sized buffers
    # (slice copies allocate before their source can be released).
    n_patched = 0
    if refine_mode:
        from hpc_suffix_array_tpu.core.refine import refine_ties

        # Hand slab ownership to the refiner (donated scatters refine
        # the idx slab in place; the tie slab frees right after its
        # bit-packing): the pop() calls strip this frame's references
        # at argument-evaluation time.
        if not want_lcp:
            del k0B
            k0B = None
        bufs = [idxB, k1B, k0B]
        del idxB, k1B, k0B
        sa, lcp = refine_ties(
            text_pad, bufs.pop(0), bufs.pop(1), bufs.pop(0), n,
            spw_main=plan.spw, d0_words=2, sigma=int(plan.remap.max()),
            minpad=plan.minpad, ranges=ranges, vals=vals_d,
            host_text=state["host_text"], want_lcp=want_lcp,
            meta=plan.meta)
        n_patched = int(plan.meta.get("refine_host_members", 0))
    else:
        del k1B
        lcp = None
        if want_lcp:
            lcp = k0B[:n]
        del k0B
        sa = idxB[:n]
        del idxB
        if patches:
            sa, lcp, n_patched = _apply_residue(
                sa, lcp, state["host_text"],
                [(slots.astype(np.int64), idxs)
                 for _b, slots, idxs in patches],
                n, want_lcp)
    if want_lcp and plan.minpad:
        lcp = _clamp_lcp(sa, lcp, jnp.int32(n))

    plan.meta["n_buckets_run"] = len(live)
    plan.meta["chain_mode"] = chain_mode
    plan.meta["periods"] = sorted(verified)
    plan.meta["n_patched"] = n_patched
    # The final bucket writes + patch run async; their tail is attributed
    # by the caller's fence. Durations between the recorded sync points:
    plan.meta["phase_host_s"] = {
        name: round(t1 - t0, 3)
        for (_, t0), (name, t1) in zip(_stamps, _stamps[1:])}
    return (sa, lcp) if want_lcp else sa


def build_suffix_array_big(text, info: dict | None = None,
                           **kw) -> jnp.ndarray:
    """One-call build (see prepare_big/execute_big for the staged form).

    ``info``: optional dict the plan's meta is copied into after the
    build (rerun honesty keys, chain_mode, n_patched, ...) — the
    one-call API's window into what the staged form exposes as
    ``state["plan"].meta``."""
    exec_kw = {k: kw.pop(k)
               for k in ("max_bucket_elems", "want_lcp") if k in kw}
    state = prepare_big(text, **kw)
    out = execute_big(state, **exec_kw)
    if info is not None:
        info.update({k: v for k, v in state["plan"].meta.items()
                     if k in ("rerun", "chain_mode", "n_patched",
                              "periods", "refine_members",
                              "refine_rounds", "refine_pieces",
                              "refine_host_members")})
    return out


# ---------------------------------------------------------------------------
# Direct one-sort path: texts whose carried-key triple fits a single
# device sort. The MSD count/scatter/bucket machinery exists to split
# work that can't be one sort; below ~SA_DIRECT_MAX it sorts all data
# TWICE (scatter + bucket passes) where once suffices. This path packs
# (k0, k1, idx) for the whole text and runs ONE 3-key sort, then reuses
# the bucket machinery verbatim: _bucket_sort (as a single whole-text
# "bucket"), the chain-mode theorem, _extract_ties + host residue, and
# the want_lcp xor/clz derivation. It beat the two-sort MSD at every
# size it fits on an earlier accelerator; not re-measured on the GPU.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 6, 7, 8))
def _direct_keys(n_pad: int, spw: int, bits: int, text_ext, vals, n,
                 ranges=None, nw: int = 2, minpad: bool = False):
    """(k0, .., k_{nw-1}, iota) for the whole text — PAD_KEY past n, so
    pads sort to the tail and the first n sorted rows are the suffix
    array. ``nw`` carried words resolve nw*spw leading symbols."""
    pos_ext = lax.iota(jnp.int32, n_pad + nw * spw)
    codes = codes_from_bytes(text_ext, vals, ranges)
    codes = jnp.where(pos_ext < n, codes - (1 if minpad else 0), 0)
    iota = lax.iota(jnp.int32, n_pad)
    ok = iota < n
    words = tuple(
        jnp.where(ok, _dev_pack_word(codes, w * spw, spw, bits, n_pad),
                  PAD_KEY)
        for w in range(nw))
    return words + (iota,)


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _direct_sort3(desc_idx: bool, want_lcp: bool, spw: int, bits: int,
                  k0, k1, k2, idx, n):
    """3-word ``_bucket_sort`` for the direct path (small alphabets).

    One extra carried word deepens the resolved window to 3*spw symbols,
    shrinking the expected window-tied residue by sigma^spw — DNA at the
    2^28 ladder config predicts ~2^16 tied pairs with 2 words (beyond
    the extraction cap, so r2 routed it to the MSD's per-bucket caps)
    and ~0 with 3. Costs one sort operand; routed only when 2 words are
    residue-infeasible (``prepare_direct``). Single whole-text bucket:
    the previous-bucket sentinel of ``_bucket_sort`` is inlined (-1
    mismatches at bit 31, clamping lcp[0] to 0). Returns
    (s_idx, tie flags, tie count, dmax, delta_ok, lcp int32).
    """
    S = k0.shape[0]
    big = jnp.int32(1) << 30
    iota = lax.iota(jnp.int32, S)
    real = iota < n
    tb = jnp.where(real, (n - idx) if desc_idx else idx, big)
    # Same comparator economics as _bucket_sort: tb is a key only in
    # chain mode; never stable.
    sk0, sk1, sk2, st = lax.sort((k0, k1, k2, tb),
                                 num_keys=4 if desc_idx else 3,
                                 is_stable=False)
    s_idx = (n - st) if desc_idx else st
    neg1 = jnp.full((1,), -1, jnp.int32)
    pk0 = jnp.concatenate([neg1, sk0[:-1]])
    pk1 = jnp.concatenate([neg1, sk1[:-1]])
    pk2 = jnp.concatenate([neg1, sk2[:-1]])
    tie = (sk0 == pk0) & (sk1 == pk1) & (sk2 == pk2) & real
    prev_idx = jnp.concatenate([s_idx[:1], s_idx[:-1]])
    delta = jnp.where(tie, (prev_idx - s_idx) if desc_idx
                      else (s_idx - prev_idx), 0)
    dmax = jnp.max(jnp.where(tie, delta, 0))
    dmin = jnp.min(jnp.where(tie, delta, big))
    delta_ok = (~jnp.any(tie)) | ((dmin == dmax) & (dmax >= 1))
    if want_lcp:
        depth = jnp.int32(3 * spw)
        x0, x1, x2 = pk0 ^ sk0, pk1 ^ sk1, pk2 ^ sk2
        off0 = jnp.where(x0 != 0,
                         spw - 1 - (31 - lax.clz(x0)) // bits, depth)
        off1 = jnp.where(x1 != 0,
                         2 * spw - 1 - (31 - lax.clz(x1)) // bits, depth)
        off2 = jnp.where(x2 != 0,
                         3 * spw - 1 - (31 - lax.clz(x2)) // bits, depth)
        lcp = jnp.maximum(
            jnp.where(x0 != 0, off0, jnp.where(x1 != 0, off1, off2)), 0)
        if desc_idx:
            lcp = jnp.where(tie, n - prev_idx, lcp)
        lcp32 = jnp.where(real, lcp, 0).astype(jnp.int32)
    else:
        lcp32 = jnp.zeros((1,), jnp.int32)
    return (s_idx, tie.astype(jnp.int32), jnp.sum(tie.astype(jnp.int32)),
            dmax, delta_ok.astype(jnp.int32), lcp32)


def residue_feasible_sigma(sigma: int, n: int, cap: float,
                           est_repeat: int, words: int = 2,
                           spw: int | None = None) -> bool:
    """``residue_feasible`` arithmetic from precomputed inputs — for
    callers that never hold the text (the multi-process sharded build
    derives sigma from a device histogram and est_repeat from
    allgathered local estimates)."""
    sigma = max(int(sigma), 2)
    if spw is None:
        spw = packing_from_sigma(sigma)[1]
    log_pred = 2 * math.log(n) - words * spw * math.log(sigma)
    if log_pred < math.log(max(cap, 2.0)):
        return True
    return est_repeat > words * spw      # periodic: chain rule, no cap


def residue_feasible(arr: np.ndarray, n: int, cap: float,
                     est_repeat: int | None = None,
                     words: int = 2, spw: int | None = None,
                     sigma: int | None = None) -> bool:
    """Expected window-tied residue fits ``cap`` — or the text looks
    globally periodic, where the chain rule resolves ties analytically
    with no cap. Shared gate for the carried-keys paths (direct, and
    the sharded one-pass MSD whose cap scales with the shard count).
    ``words`` carried key words resolve words*spw symbols (the third
    word shrinks the prediction by sigma^spw — the small-alphabet fix,
    see _direct_sort3). Uniformity assumption: skewed real texts that
    slip past it raise NotImplementedError downstream and the caller
    falls back. ``spw`` defaults to the packing_mode density for the
    text's alphabet; the parameter exists so callers that already
    computed their packing geometry can pass it and skip the rescan
    (every carried-keys builder packs via packing_mode today).
    ``sigma``/``est_repeat``: precomputed planning products — the
    alphabet scan is a full-text pass (~0.6 s/2^28 on this host), so
    routers that call several gates on the same text compute them once
    and thread them through (see e.g. core/lcp._sa_lcp_big)."""
    if sigma is None:
        remap, _, _ = alphabet_remap(arr)
        sigma = int(remap.max())
    # Single source of truth for the arithmetic: residue_feasible_sigma.
    # est_repeat=0 probes the cap-only accept first so the repeat scan
    # stays lazy (only texts whose prediction overflows pay it).
    if residue_feasible_sigma(sigma, n, cap, 0, words, spw):
        return True
    if est_repeat is None:
        est_repeat = estimate_repeat_len(arr)
    return residue_feasible_sigma(sigma, n, cap, est_repeat, words, spw)


def direct_feasible(arr: np.ndarray, n: int,
                    est_repeat: int | None = None,
                    sigma: int | None = None) -> bool:
    """Host-side gate for the direct path: the triple must fit one sort
    (SA_DIRECT_MAX) and the expected window-tied residue must fit the
    extraction cap (see residue_feasible)."""
    import os

    # 2^28 was a measured crossover on an earlier accelerator (a
    # bitonic network is a power-of-2 structure, so sizes just past 2^28
    # paid the 2^29 network), and a memory cap sized for a 16 GB device;
    # neither is re-derived for this card (ROADMAP item 3, D7).
    if bucket_size(n) > int(os.environ.get("SA_DIRECT_MAX", 1 << 28)):
        return False
    return (residue_feasible(arr, n, RESIDUE_SLOTS / 4, est_repeat,
                             sigma=sigma)
            or residue_feasible(arr, n, RESIDUE_SLOTS / 4, est_repeat,
                                words=3, sigma=sigma))


def prefer_direct(arr: np.ndarray, n: int,
                  est_repeat: int | None = None,
                  sigma: int | None = None) -> bool:
    """Routing preference between the two carried-keys builders.

    ``direct_feasible`` answers "CAN the one-sort path run" (memory cap
    + bounded residue); this answers "SHOULD it". On an earlier
    accelerator the one-sort path's per-element cost climbed a sort
    class every doubling of n while the MSD's two sorts stayed in the
    sub-2^23 class, so the curves crossed just past 2^27
    (``SA_DIRECT_CROSS``); the crossover is not re-measured on the GPU
    (ROADMAP item 3). Chain-class texts (globally periodic — est_repeat
    beyond the carried window) stay direct up to the feasibility cap:
    the MSD chain pass pays a count phase + residue extraction the
    direct chain build avoids.
    """
    if not direct_feasible(arr, n, est_repeat, sigma=sigma):
        return False
    cross = int(os.environ.get("SA_DIRECT_CROSS", 1 << 27))
    if bucket_size(n) <= cross:
        return True
    if est_repeat is None:
        est_repeat = estimate_repeat_len(arr)
    # Above the cross only chain-class (globally periodic) texts stay
    # direct: the MSD chain pass pays a count phase + residue
    # extraction the direct chain build avoids. The r4 gate here
    # (est_repeat > 16)
    # also caught merely duplication-heavy texts — e.g. the word
    # corpus, est ~17 from a repeated phrase — whose refinement cost is
    # route-independent; those now follow the measured random-text
    # crossover to the MSD like everything else (r5).
    return chain_plausible(est_repeat, n)


def prepare_direct(text, *, text_dev=None, n_words: int | None = None,
                   remap: np.ndarray | None = None,
                   est_repeat: int | None = None):
    """Stage the text for the direct one-sort build (untimed setup).

    ``text_dev``: optional device copy padded to ``bucket_size(n)``
    (e.g. a twin corpus); the nw*spw-symbol key-window extension is
    appended on device.

    ``n_words``: carried key words (default: auto — 2, or 3 when 2
    words' expected residue overflows the extraction cap but 3 words'
    fits; the small-alphabet case, e.g. DNA past ~2^26).

    ``remap``/``est_repeat``: precomputed planning products (see
    prepare_big)."""
    arr = as_byte_array(text)
    n = int(arr.shape[0])
    if n < 8:
        raise ValueError("direct sort needs n >= 8; use build_suffix_array")
    if remap is None:
        remap, _, _ = alphabet_remap(arr)
    bits, spw, minpad = packing_mode(remap)
    if est_repeat is None:
        est_repeat = estimate_repeat_len(arr)
    sigma = int(remap.max())
    nw = n_words
    if nw is None:
        nw = 2
        if not residue_feasible(arr, n, RESIDUE_SLOTS / 4, est_repeat,
                                sigma=sigma):
            if residue_feasible(arr, n, RESIDUE_SLOTS / 4, est_repeat,
                                words=3, sigma=sigma):
                nw = 3
    n_pad = bucket_size(n)
    if text_dev is not None and tuple(text_dev.shape) == (n_pad,):
        text_ext = jnp.concatenate(
            [text_dev, jnp.zeros(nw * spw, jnp.uint8)])
    else:
        host = np.zeros(n_pad + nw * spw, np.uint8)
        host[:n] = arr
        from hpc_suffix_array_tpu.utils.staging import stage_to_device

        text_ext = stage_to_device(host)
    return {
        "n": n, "n_pad": n_pad, "bits": bits, "spw": spw, "nw": nw,
        "minpad": minpad,
        "text_ext": text_ext, "ranges": byte_ranges(remap),
        "vals_d": jnp.asarray(np.flatnonzero(remap > 0).astype(np.uint8)),
        "host_text": arr,
        "meta": {"est_repeat": est_repeat},
    }


def execute_direct(state, *, force_chain_mode: bool | None = None,
                   want_lcp: bool = False):
    """One 3-key sort over the whole text; returns the SA (and LCP).

    Same contracts and fallbacks as execute_big, minus distribution:
    chain mode for globally periodic texts (descending tiebreak + period
    verification), bounded host residue for window-tied pairs (the ONE
    whole-text extraction shares execute_big's RESIDUE_SLOTS cap — texts
    beyond it raise NotImplementedError; the router falls back to the
    MSD path, whose per-bucket caps scale with bucket count)."""
    n, n_pad = state["n"], state["n_pad"]
    spw, bits = state["spw"], state["bits"]
    text_ext, vals_d = state["text_ext"], state["vals_d"]
    ranges = state.get("ranges")
    meta = state["meta"]

    nw = state.get("nw", 2)
    chain_mode = force_chain_mode
    if chain_mode is None:
        chain_mode = chain_plausible(meta.get("est_repeat", 0), n)

    if nw == 3:
        k0, k1, k2, iota = _direct_keys(n_pad, spw, bits, text_ext,
                                        vals_d, jnp.int32(n), ranges, 3,
                                        minpad=state.get("minpad", False))
        s_idx, tie32, ties_d, d_d, dok_d, lcp32 = _direct_sort3(
            chain_mode, want_lcp, spw, bits, k0, k1, k2, iota,
            jnp.int32(n))
        del k0, k1, k2, iota
    else:
        k0, k1, iota = _direct_keys(n_pad, spw, bits, text_ext, vals_d,
                                    jnp.int32(n), ranges,
                                    minpad=state.get("minpad", False))
        s_idx, tie32, ties_d, d_d, dok_d, lcp32, _pk0, _pk1 = _bucket_sort(
            n_pad, chain_mode, want_lcp, spw, bits, k0, k1, iota,
            jnp.int32(0), jnp.int32(n), jnp.int32(n),
            jnp.int32(-1), jnp.int32(-1))
        del k0, k1, iota
    ties = int(jax.device_get(ties_d))

    if chain_mode:
        if ties:
            d, dok = (int(x) for x in jax.device_get((d_d, dok_d)))
            if not dok:
                if force_chain_mode is None:
                    # Irregular ties: the ascending path resolves ANY
                    # tie mass (host residue under the cap, device
                    # refinement above it).
                    del s_idx, tie32, lcp32
                    meta.setdefault("rerun", []).append(
                        "chain_to_ascending")
                    return execute_direct(state, force_chain_mode=False,
                                          want_lcp=want_lcp)
                raise NotImplementedError(
                    "residual ties are not uniform arithmetic chains - "
                    "use the MSD path or the sharded build")
            if d:
                mm = int(jax.device_get(_period_mismatches(
                    text_ext, jnp.int32(d), jnp.int32(n))))
                if mm:
                    if force_chain_mode is None:
                        # Uniform-delta ties that are NOT a global
                        # period (one long repeated block): the
                        # ascending path handles any tie mass.
                        del s_idx, tie32, lcp32
                        meta.setdefault("rerun", []).append(
                            "chain_to_ascending")
                        return execute_direct(
                            state, force_chain_mode=False,
                            want_lcp=want_lcp)
                    raise NotImplementedError(
                        f"chain delta {d} is not a global period "
                        f"({mm} mismatches) - use the MSD path")
                meta["periods"] = [d]
    elif (ties > n // 4
          and chain_plausible(meta.get("est_repeat", 0), n)
          and "chain_to_ascending" not in meta.get("rerun", [])):
        # Periodic-looking text ran ascending: one chain redo. Heavily
        # tied but aperiodic texts go to refinement instead, and a
        # build that fell back FROM chain never flips again.
        del s_idx, tie32, lcp32
        meta.setdefault("rerun", []).append("ascending_to_chain")
        return execute_direct(state, force_chain_mode=True,
                              want_lcp=want_lcp)

    patches = []
    refine_mode = False
    # Same gate semantics as execute_big: the direct build is one
    # whole-text "bucket", so the per-bucket member cap applies to the
    # single flag count (members <= 2*flags + groups).
    host_cap = int(os.environ.get("SA_HOST_RESIDUE_MAX", 1 << 20))
    if ties and not chain_mode:
        if ties * 2 > RESIDUE_SLOTS or ties > host_cap:
            refine_mode = True
        else:
            slots_d, idx_d, total_d = _extract_ties(
                n_pad, tie32, s_idx, jnp.int32(0), jnp.int32(n))
            total = int(jax.device_get(total_d))
            if total > RESIDUE_SLOTS:
                # Beyond the extraction cap: the device refinement pass
                # has no such bound (pre-r5 this was a refusal).
                refine_mode = True
            else:
                slots = np.asarray(jax.device_get(slots_d))[:total]
                idxs = np.asarray(jax.device_get(idx_d))[:total]
                patches.append((slots.astype(np.int64), idxs))
            del slots_d, idx_d

    if refine_mode:
        from hpc_suffix_array_tpu.core.refine import refine_ties

        if not want_lcp:
            del lcp32
            lcp32 = None
        bufs = [s_idx, tie32, lcp32]
        del s_idx, tie32, lcp32
        sa, lcp = refine_ties(
            text_ext, bufs.pop(0), bufs.pop(1), bufs.pop(0), n,
            spw_main=spw, d0_words=nw,
            sigma=int(state["vals_d"].shape[0]),
            minpad=state.get("minpad", False), ranges=ranges,
            vals=vals_d, host_text=state["host_text"],
            want_lcp=want_lcp, meta=meta)
        meta["n_patched"] = int(meta.get("refine_host_members", 0))
    else:
        del tie32
        sa = s_idx[:n]
        del s_idx
        lcp = lcp32[:n] if want_lcp else None
        del lcp32
        if patches:
            sa, lcp, n_patched = _apply_residue(
                sa, lcp, state["host_text"], patches, n, want_lcp)
            meta["n_patched"] = n_patched
    if want_lcp and state.get("minpad", False):
        lcp = _clamp_lcp(sa, lcp, jnp.int32(n))
    meta["chain_mode"] = chain_mode
    return (sa, lcp) if want_lcp else sa


def build_suffix_array_direct(text, info: dict | None = None, **kw):
    """One-call direct build (see prepare_direct/execute_direct).

    ``info``: optional dict the build meta is copied into (rerun
    honesty keys, chain_mode, n_patched — see build_suffix_array_big).
    """
    exec_kw = {k: kw.pop(k)
               for k in ("force_chain_mode", "want_lcp") if k in kw}
    state = prepare_direct(text, **kw)
    out = execute_direct(state, **exec_kw)
    if info is not None:
        info.update({k: v for k, v in state["meta"].items()
                     if k in ("rerun", "chain_mode", "n_patched",
                              "periods", "refine_members",
                              "refine_rounds", "refine_pieces",
                              "refine_host_members")})
    return out
