"""Distributed one-pass MSD (carried-keys) suffix build over a mesh.

The sharded doubling builder (parallel/doubling.py) pays log(n) rounds of
(bitonic sort + re-rank + route-back); on texts whose suffixes separate
within the first 2*spw symbols (every corpus family of the reference's
generator: random, DNA, and — via chain mode — periodic), ONE distributed
sort of the carried key pair (k0, k1) already yields the suffix array, up
to a bounded residue of still-tied positions. This module is the mesh
version of core/bigsort.py's carried-keys design, built from the same
distributed primitives as the doubling path:

  * per-shard key packing with a 2*spw-code neighbor halo (one
    statically-patterned ppermute, like doubling's ``_pack_local``);
  * ONE oblivious block-bitonic sort of (k0, k1, tiebreak) — skew-immune,
    static communication pattern (parallel/bitonic.py);
  * tie flags + chain-delta stats via a boundary ppermute (each shard
    compares its first sorted record against its left neighbor's last) +
    psum/pmax reductions — O(P) scalars of traffic;
  * residue compaction per shard into fixed RESIDUE_SLOTS records
    (sort-based, no scatter), resolved by direct comparison and patched
    into the sharded SA (bounded transfer);
  * periodic texts: the same descending-index tiebreak as
    core/bigsort.py chain mode (for a global period d, s_{i+d} is a
    strict prefix of s_i), with the period verified against the text.

Two text-access strategies drive the same orchestration (_build):

  * ``_HostText`` — the convenience API (`build_suffix_array_sharded_big`):
    one process holds the whole text; alphabet scan, repeat estimate,
    period verification and residue resolution run on the host copy.
  * ``_DistText`` — the multi-process API
    (`build_suffix_array_sharded_big_mp`): every process feeds ONLY its
    local block (`jax.make_array_from_process_local_data`); the alphabet
    comes from a device histogram psum, the repeat estimate from
    per-process local estimates (allgathered max), period verification
    from a device-side shifted compare (log P conditional ring rotations
    + one halo ppermute — O(n log P / P) bytes per link, no host text),
    and residue ties resolve from bounded text windows fetched by
    distributed gathers (parallel/gather.py). Ties deeper than the
    window budget raise NotImplementedError — the same fallback contract
    as the single-process path (callers use the doubling builder).

This is the "≥ 4 GiB across ≥ 2 hosts" ladder config's builder
(BASELINE.md): per-chip working set is one sort pass over 12 B/char of
carried keys + the text shard — no rank arrays carried across log(n)
rounds — and every collective is a static-pattern ppermute riding
neighbor NVLink links. Pathological inputs (irregular massive ties) raise
NotImplementedError; callers fall back to the doubling builder, which
handles them at any skew.

Reference scope note: this replaces the master-centric MPI round
(src/mpi/manber_myers_mpi.c:108-143) like parallel/doubling.py does, but
with single-pass semantics; output is byte-identical to the sequential
reference on all supported inputs (the suffix array is unique). Unlike
the reference's multi-process build, which replicates the whole text on
every rank (src/mpi/main_mpi.c:43-51), the _mp entry never materializes
the text anywhere.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec

from hpc_suffix_array_tpu.core.bigsort import (
    PAD_KEY, RESIDUE_SLOTS, ResidueDepthError, _clamp_lcp,
    _resolve_residue_host, byte_ranges, codes_from_bytes,
    estimate_repeat_len, packing_mode, residue_feasible)
from hpc_suffix_array_tpu.core.suffix_array import (
    alphabet_remap, as_byte_array, bucket_size)
from hpc_suffix_array_tpu.parallel.bitonic import block_bitonic_sort
from hpc_suffix_array_tpu.parallel.gather import dist_gather
from hpc_suffix_array_tpu.parallel.mesh import (
    SEQ_AXIS, make_mesh, sequence_sharding)

_BIG = np.int32(1 << 30)   # np, not jnp: no device buffer at import
#                            (backend init before callers configure it)


def _boundary_prev(cols, axis_name: str, n_shards: int):
    """Each shard's view of its left neighbor's LAST sorted record.

    ``cols`` is a tuple of int32[m] sorted columns; returns a tuple of
    scalars. Shard 0 receives zeros — NOT always distinguishable from a
    real record: under minpad packing an all-min-symbol suffix
    legitimately packs to key 0, so shard 0's manufactured zero packet
    CAN compare equal to its first real row. Callers must mask the
    first global row themselves (both _local_build and _local_build_wide
    do, via ``gpos > 0`` / ``~first_global``)."""
    packet = jnp.stack([c[-1] for c in cols])
    perm = [(i, i + 1) for i in range(n_shards - 1)]
    got = lax.ppermute(packet, axis_name, perm)
    return tuple(got[i] for i in range(len(cols)))


def _pack_words(ext, m: int, spw: int, bits: int, nw: int):
    """nw carried key words from m + nw*spw halo-extended codes."""
    words = []
    for w in range(nw):
        kw = jnp.zeros((m,), jnp.int32)
        for s in range(spw):
            kw = (kw << bits) | lax.slice(ext, (w * spw + s,),
                                          (w * spw + s + m,))
        words.append(kw)
    return words


def _key_lcp(prev_words, sorted_words, spw: int, bits: int, nw: int):
    """First-mismatch depth (symbols) of adjacent sorted carried keys.

    xor + count-leading-zeros per word (symbols pack first-highest in
    the low spw*bits bits); fully-equal rows return the nw*spw lower
    bound (ties — chain rule or host residue finish them)."""
    depth = jnp.int32(nw * spw)
    lcp = depth
    for w in range(nw - 1, -1, -1):
        x = prev_words[w] ^ sorted_words[w]
        off = jnp.where(x != 0,
                        (w + 1) * spw - 1 - (31 - lax.clz(x)) // bits,
                        depth)
        lcp = jnp.where(x != 0, off, lcp)
    return jnp.maximum(lcp, 0)


def _local_build(P: int, bits: int, spw: int, R: int, ranges, nw: int,
                 minpad: bool, text_u8, vals, n_real, desc):
    """shard_map body: pack carried keys, one global sort, flags + residue.

    Returns (s_idx[m], lcp[m], slots[R], res_idx[R], stats[6]) per shard;
    stats = (tie_cnt, dmax, dmin, res_total, overflow_any, _pad), ALL
    axis-uniform (psum/pmax/pmin-reduced) so the stats output replicates
    and any process can read it. ``lcp[j] = LCP(sa[j-1], sa[j])`` comes
    from adjacent xor + count-leading-zeros on the sorted carried keys
    (exact for every pair that mismatches within nw*spw symbols; the
    chain rule covers periodic ties in-kernel, the residue patch covers
    the bounded rest) — a handful of elementwise passes on columns the
    sort already moved, so it is always computed. ``nw`` carried words
    (2, or 3 for small alphabets whose 2-word residue overflows the caps
    — the core _direct_sort3 rationale, sharded).
    """
    m = text_u8.shape[0]
    me = lax.axis_index(SEQ_AXIS)
    g = me * m + lax.iota(jnp.int32, m)

    codes = codes_from_bytes(text_u8, vals, ranges)
    codes = jnp.where(g < n_real, codes - (1 if minpad else 0), 0)
    halo = lax.ppermute(codes[:nw * spw], SEQ_AXIS,
                        [(i, i - 1) for i in range(1, P)])
    ext = jnp.concatenate([codes, halo])             # m + nw*spw codes
    words = _pack_words(ext, m, spw, bits, nw)

    real = g < n_real
    words = [jnp.where(real, w, PAD_KEY) for w in words]
    tb = jnp.where(real, jnp.where(desc, n_real - g, g), _BIG)

    out = block_bitonic_sort(tuple(words) + (tb,), num_keys=nw + 1,
                             axis_name=SEQ_AXIS, n_shards=P)
    sw, tbs = list(out[:nw]), out[nw]
    gpos = me * m + lax.iota(jnp.int32, m)           # global sorted slot
    real_s = gpos < n_real                           # pads sort last
    s_idx = jnp.where(real_s, jnp.where(desc, n_real - tbs, tbs), n_real)

    # Tie with the global predecessor (boundary record via one ppermute).
    bprev = _boundary_prev(tuple(sw) + (tbs,), SEQ_AXIS, P)
    prev_w = [jnp.concatenate([bprev[w][None], sw[w][:-1]])
              for w in range(nw)]
    prev_ix = jnp.where(desc, n_real - bprev[nw], bprev[nw])
    prev_idx = jnp.concatenate([prev_ix[None], s_idx[:-1]])
    tie = real_s & (gpos > 0)
    for w in range(nw):
        tie &= sw[w] == prev_w[w]
    delta = jnp.where(tie, jnp.where(desc, prev_idx - s_idx,
                                     s_idx - prev_idx), 0)
    tie_cnt = lax.psum(jnp.sum(tie.astype(jnp.int32)), SEQ_AXIS)
    dmax = lax.pmax(jnp.max(jnp.where(tie, delta, 0)), SEQ_AXIS)
    dmin = lax.pmin(jnp.min(jnp.where(tie, delta, _BIG)), SEQ_AXIS)

    # LCP from the carried keys (mirror of core _bucket_sort want_lcp).
    lcp = _key_lcp(prev_w, sw, spw, bits, nw)
    # Periodic ties: chain members are consecutive, lcp = n - prev_idx.
    lcp = jnp.where(tie & desc, n_real - prev_idx, lcp)
    # Row 0's manufactured zero predecessor and pad rows clamp to 0.
    lcp = jnp.where(real_s & (gpos > 0), lcp, 0).astype(jnp.int32)

    # Residue membership: every element of a tied group (the flag marks
    # the later element of each tied pair; group heads join through their
    # successor's flag, pulled across the right boundary).
    nxt0 = lax.ppermute(tie[:1].astype(jnp.int32), SEQ_AXIS,
                        [(i, i - 1) for i in range(1, P)])[0]
    next_tie = jnp.concatenate([tie[1:].astype(jnp.int32), nxt0[None]])
    member = (tie | (next_tie > 0)) & real_s
    keyed = jnp.where(member, lax.iota(jnp.int32, m), _BIG)
    # Unstable: member keys are distinct iota values; the shared _BIG
    # tail's payload order is dead (sliced off by the member count).
    o_slot, o_idx = lax.sort((keyed, s_idx), num_keys=1, is_stable=False)
    k = min(R, m)
    slots = jnp.where(o_slot[:k] < _BIG, gpos[0] + o_slot[:k], -1)
    slots = jnp.concatenate([slots, jnp.full((R - k,), -1, jnp.int32)])
    res_idx = jnp.concatenate(
        [o_idx[:k], jnp.zeros((R - k,), jnp.int32)])
    res_cnt = jnp.sum(member.astype(jnp.int32))
    stats = jnp.stack([tie_cnt, dmax, dmin, lax.psum(res_cnt, SEQ_AXIS),
                       lax.psum((res_cnt > R).astype(jnp.int32), SEQ_AXIS),
                       jnp.int32(0)])
    return s_idx, lcp, slots, res_idx, stats


def _local_build_wide(P: int, bits: int, spw: int, R: int, ranges,
                      nw: int, minpad: bool, text_u8, vals, n_hi, n_lo,
                      desc):
    """``_local_build`` with TWO-WORD global indices: the >=4 GiB path.

    Global suffix index g = hi * m + lo (hi = shard id, lo = local
    offset, both int32) — n up to P * 2^31 with no int64 sort operands
    (an (nw+2)-key int32 sort keeps every operand 32-bit). Descending order uses the exact
    two-word complement (P*m - 1) - g = (P-1-hi, m-1-lo). Index compares
    (real mask, tie deltas) are lexicographic (hi, lo) pairs; delta
    uniformity is checked componentwise (all pairs equal <=> both
    columns' pmax == pmin, since fills are 0 / +inf and deltas are
    nonnegative). The LCP rides as the same two-word (hi, lo) base-m
    pair: in-window values are tiny (<= nw*spw, lo word only), chain-
    rule values n - prev_g use exact two-word borrow arithmetic — this
    is the wide build's LCP path (r2 raised NotImplementedError here).
    Returns per shard: (s_hi[m], s_lo[m], lcp_hi[m], lcp_lo[m],
    slot_lo[R], res_hi[R], res_lo[R], stats[8]); slots are LOCAL sorted
    offsets (-1 pads) — the caller adds shard*m. stats = (tie_cnt,
    dmax_hi, dmin_hi, dmax_lo, dmin_lo, res_total, overflow_any, _pad),
    all axis-uniform (replicated output).
    """
    m = text_u8.shape[0]
    me = lax.axis_index(SEQ_AXIS)
    lo = lax.iota(jnp.int32, m)

    def lt_n(hi, lo_):
        return (hi < n_hi) | ((hi == n_hi) & (lo_ < n_lo))

    codes = codes_from_bytes(text_u8, vals, ranges)
    codes = jnp.where(lt_n(me, lo), codes - (1 if minpad else 0), 0)
    halo = lax.ppermute(codes[:nw * spw], SEQ_AXIS,
                        [(i, i - 1) for i in range(1, P)])
    ext = jnp.concatenate([codes, halo])
    words = _pack_words(ext, m, spw, bits, nw)

    real = lt_n(me, lo)
    words = [jnp.where(real, w, PAD_KEY) for w in words]
    tbh = jnp.where(real, jnp.where(desc, P - 1 - me, me), _BIG)
    tbl = jnp.where(real, jnp.where(desc, m - 1 - lo, lo), _BIG)

    out = block_bitonic_sort(tuple(words) + (tbh, tbl), num_keys=nw + 2,
                             axis_name=SEQ_AXIS, n_shards=P)
    sw, tbhs, tbls = list(out[:nw]), out[nw], out[nw + 1]
    real_s = sw[0] != PAD_KEY                        # pads sort last
    for w in range(1, nw):
        real_s |= sw[w] != PAD_KEY
    s_hi = jnp.where(real_s, jnp.where(desc, P - 1 - tbhs, tbhs), n_hi)
    s_lo = jnp.where(real_s, jnp.where(desc, m - 1 - tbls, tbls), n_lo)

    bprev = _boundary_prev(tuple(sw) + (s_hi, s_lo), SEQ_AXIS, P)
    prev_w = [jnp.concatenate([bprev[w][None], sw[w][:-1]])
              for w in range(nw)]
    prev_hi = jnp.concatenate([bprev[nw][None], s_hi[:-1]])
    prev_lo = jnp.concatenate([bprev[nw + 1][None], s_lo[:-1]])
    first_global = (me == 0) & (lo == 0)
    tie = real_s & ~first_global
    for w in range(nw):
        tie &= sw[w] == prev_w[w]
    # delta = |g - g_prev| as a two-word (hi, lo) pair with borrow.
    a_hi = jnp.where(desc, prev_hi, s_hi)
    a_lo = jnp.where(desc, prev_lo, s_lo)
    b_hi = jnp.where(desc, s_hi, prev_hi)
    b_lo = jnp.where(desc, s_lo, prev_lo)
    borrow = (a_lo < b_lo).astype(jnp.int32)
    d_lo = a_lo - b_lo + borrow * m
    d_hi = a_hi - b_hi - borrow
    tie_cnt = lax.psum(jnp.sum(tie.astype(jnp.int32)), SEQ_AXIS)
    dmax_hi = lax.pmax(jnp.max(jnp.where(tie, d_hi, 0)), SEQ_AXIS)
    dmin_hi = lax.pmin(jnp.min(jnp.where(tie, d_hi, _BIG)), SEQ_AXIS)
    dmax_lo = lax.pmax(jnp.max(jnp.where(tie, d_lo, 0)), SEQ_AXIS)
    dmin_lo = lax.pmin(jnp.min(jnp.where(tie, d_lo, _BIG)), SEQ_AXIS)

    # LCP as a two-word base-m pair. In-window first mismatches are tiny
    # (<= nw*spw — lo word only); chain-rule ties get the exact
    # lcp = n - prev_g with borrow; ascending ties keep the nw*spw lower
    # bound for the residue patch (same contract as _local_build).
    key_lcp = _key_lcp(prev_w, sw, spw, bits, nw)
    nb = (n_lo < prev_lo).astype(jnp.int32)
    chain_lo = n_lo - prev_lo + nb * m
    chain_hi = n_hi - prev_hi - nb
    use_chain = tie & desc
    gpos_ok = real_s & ~first_global
    lcp_hi = jnp.where(gpos_ok & use_chain, chain_hi, 0).astype(jnp.int32)
    lcp_lo = jnp.where(gpos_ok, jnp.where(use_chain, chain_lo, key_lcp),
                       0).astype(jnp.int32)

    nxt0 = lax.ppermute(tie[:1].astype(jnp.int32), SEQ_AXIS,
                        [(i, i - 1) for i in range(1, P)])[0]
    next_tie = jnp.concatenate([tie[1:].astype(jnp.int32), nxt0[None]])
    member = (tie | (next_tie > 0)) & real_s
    keyed = jnp.where(member, lo, _BIG)
    o_slot, o_hi, o_lo = lax.sort((keyed, s_hi, s_lo), num_keys=1,
                                  is_stable=False)
    k = min(R, m)
    slot_lo = jnp.where(o_slot[:k] < _BIG, o_slot[:k], -1)
    slot_lo = jnp.concatenate([slot_lo, jnp.full((R - k,), -1, jnp.int32)])
    res_hi = jnp.concatenate([o_hi[:k], jnp.zeros((R - k,), jnp.int32)])
    res_lo = jnp.concatenate([o_lo[:k], jnp.zeros((R - k,), jnp.int32)])
    res_cnt = jnp.sum(member.astype(jnp.int32))
    stats = jnp.stack([tie_cnt, dmax_hi, dmin_hi, dmax_lo, dmin_lo,
                       lax.psum(res_cnt, SEQ_AXIS),
                       lax.psum((res_cnt > R).astype(jnp.int32), SEQ_AXIS),
                       jnp.int32(0)])
    return s_hi, s_lo, lcp_hi, lcp_lo, slot_lo, res_hi, res_lo, stats


@functools.cache
def _kernels(mesh: Mesh, bits: int, spw: int, ranges, nw: int = 2,
             minpad: bool = False):
    P = int(mesh.devices.size)
    spec = PartitionSpec(SEQ_AXIS)
    rep = PartitionSpec()
    f = jax.shard_map(
        functools.partial(_local_build, P, bits, spw, RESIDUE_SLOTS,
                          ranges, nw, minpad),
        mesh=mesh,
        in_specs=(spec, rep, rep, rep),
        out_specs=(spec, spec, spec, spec, rep),
        check_vma=False)
    return jax.jit(f)


@functools.cache
def _kernels_wide(mesh: Mesh, bits: int, spw: int, ranges, nw: int = 2,
                  minpad: bool = False):
    P = int(mesh.devices.size)
    spec = PartitionSpec(SEQ_AXIS)
    rep = PartitionSpec()
    f = jax.shard_map(
        functools.partial(_local_build_wide, P, bits, spw, RESIDUE_SLOTS,
                          ranges, nw, minpad),
        mesh=mesh,
        in_specs=(spec, rep, rep, rep, rep),
        out_specs=(spec,) * 7 + (rep,),
        check_vma=False)
    return jax.jit(f)


@functools.cache
def _clamp_kernel_wide(mesh: Mesh):
    """Two-word shorter-suffix-length clamp over the assembled sharded
    (sa, lcp) column pairs — the wide counterpart of core ``_clamp_lcp``
    (see its docstring for why minpad packing needs this and why it must
    run AFTER the residue patch). g = hi * m + lo; all compares and the
    n - max(prev_g, g) subtraction are exact two-word base-m arithmetic.
    Global row 0's manufactured zero predecessor loses the max() against
    any real g, so lcp[0] = 0 is preserved; pad rows (g = n) clamp to 0,
    which they already are."""
    P = int(mesh.devices.size)
    spec = PartitionSpec(SEQ_AXIS)
    rep = PartitionSpec()

    def body(s_hi, s_lo, lcp_hi, lcp_lo, n_hi, n_lo):
        m = s_hi.shape[0]
        bprev = _boundary_prev((s_hi, s_lo), SEQ_AXIS, P)
        p_hi = jnp.concatenate([bprev[0][None], s_hi[:-1]])
        p_lo = jnp.concatenate([bprev[1][None], s_lo[:-1]])
        use_prev = (p_hi > s_hi) | ((p_hi == s_hi) & (p_lo > s_lo))
        m_hi = jnp.where(use_prev, p_hi, s_hi)
        m_lo = jnp.where(use_prev, p_lo, s_lo)
        borrow = (n_lo < m_lo).astype(jnp.int32)
        len_lo = n_lo - m_lo + borrow * m
        len_hi = n_hi - m_hi - borrow
        use_len = (len_hi < lcp_hi) | ((len_hi == lcp_hi)
                                       & (len_lo < lcp_lo))
        return (jnp.where(use_len, len_hi, lcp_hi),
                jnp.where(use_len, len_lo, lcp_lo))

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(spec, spec, spec, spec, rep, rep),
        out_specs=(spec, spec), check_vma=False))


@functools.cache
def _patch_kernel(mesh: Mesh):
    """Per-shard scatter of resolved residue values into a sharded
    column: each shard receives its own RESIDUE_SLOTS (local offset,
    value) rows, -1 slots are pads."""
    spec = PartitionSpec(SEQ_AXIS)

    def body(col, slots, vals):
        # Pads (-1) scatter out of range and drop — never clamp pads to
        # a real slot alongside a genuine patch for it (duplicate-index
        # set() ordering is undefined; see core _apply_patch, soak r3).
        m = col.shape[0]
        tgt = jnp.where(slots >= 0, slots, m)
        return col.at[tgt].set(vals, mode="drop")

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(spec, spec, spec), out_specs=spec,
        check_vma=False))


@functools.cache
def _present_kernel(mesh: Mesh):
    """Alphabet presence over the sharded text: per-shard 256-bin
    histogram of real positions, psum'd to a replicated presence vector
    — the multi-process stand-in for the host alphabet_remap bincount
    (every process reads the same replicated 256 ints; no process needs
    the whole text). n rides as the two-word (n // m, n % m) pair so the
    same kernel serves wide (> int32) lengths."""
    P = int(mesh.devices.size)
    spec = PartitionSpec(SEQ_AXIS)
    rep = PartitionSpec()

    def body(text_u8, n_hi, n_lo):
        m = text_u8.shape[0]
        me = lax.axis_index(SEQ_AXIS)
        lo = lax.iota(jnp.int32, m)
        real = (me < n_hi) | ((me == n_hi) & (lo < n_lo))
        h = jnp.zeros((256,), jnp.int32).at[text_u8.astype(jnp.int32)].add(
            real.astype(jnp.int32))
        return lax.psum((h > 0).astype(jnp.int32), SEQ_AXIS)

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(spec, rep, rep), out_specs=rep,
        check_vma=False))


@functools.cache
def _period_kernel(mesh: Mesh):
    """Device-side global-period check: ANY t < n - d with
    text[t] != text[t + d]? (replicated 0/positive count of shards that
    saw a mismatch).

    d arrives as the two-word (d // m, d % m) pair, TRACED — one
    compiled program covers every period. The whole-shard part of the
    shift is log2(P) CONDITIONAL ring rotations (rotate-by-2^j kept or
    discarded per bit of d_hi — the permutation patterns stay static);
    the sub-shard remainder is one halo ppermute + a traced
    dynamic_slice. Replaces the host whole-text compare
    (np.any(arr[:-d] != arr[d:])) for processes that hold only their
    local block. Cost: O(m log P) bytes per link + one elementwise
    compare — nothing n-sized leaves the device.
    """
    P = int(mesh.devices.size)
    spec = PartitionSpec(SEQ_AXIS)
    rep = PartitionSpec()

    def body(text_u8, d_hi, d_lo, n_hi, n_lo):
        m = text_u8.shape[0]
        me = lax.axis_index(SEQ_AXIS)
        lo = lax.iota(jnp.int32, m)
        blk = text_u8
        j, step = 0, 1
        while step < P:
            rot = lax.ppermute(blk, SEQ_AXIS,
                               [(i, (i - step) % P) for i in range(P)])
            blk = jnp.where(((d_hi >> j) & 1) == 1, rot, blk)
            j += 1
            step <<= 1
        nxt = lax.ppermute(blk, SEQ_AXIS,
                           [(i, (i - 1) % P) for i in range(P)])
        ext = jnp.concatenate([blk, nxt])
        shifted = lax.dynamic_slice(ext, (d_lo,), (m,))
        # g + d as a two-word (hi, lo) pair; positions past n - d are
        # excluded (this also kills every mod-P-wrapped rotation read:
        # valid => g + d < n <= n_pad, i.e. the unwrapped block).
        lo2 = lo + d_lo
        carry = (lo2 >= m).astype(jnp.int32)
        lo2 = lo2 - carry * m
        hi2 = me + d_hi + carry
        valid = (hi2 < n_hi) | ((hi2 == n_hi) & (lo2 < n_lo))
        bad = (text_u8 != shifted) & valid
        return lax.psum(jnp.any(bad).astype(jnp.int32), SEQ_AXIS)

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(spec, rep, rep, rep, rep),
        out_specs=rep, check_vma=False))


@functools.cache
def _window_kernel(mesh: Mesh, W: int, U: int, RW: int):
    """Replicated W-byte text windows at U query positions.

    Queries arrive replicated as (row, offset) pairs with row width
    ``RW`` (a power of two dividing both the shard size m and W); the
    kernel gathers W // RW + 1 consecutive RW-rows per query through
    ``dist_gather`` (every shard serves the same queries as the value
    blocks rotate past, so the output replicates naturally) and carves
    the unaligned window out locally. This is how multi-process residue
    resolution reads text it does not own: P * R queries x W bytes of
    bounded traffic instead of any process materializing the text."""
    P = int(mesh.devices.size)
    spec = PartitionSpec(SEQ_AXIS)
    rep = PartitionSpec()
    nr = W // RW + 1

    def body(text_u8, q, off):
        m = text_u8.shape[0]
        rows = text_u8.reshape(m // RW, RW)
        parts = [dist_gather(rows, q + j, SEQ_AXIS, P, fill=0)
                 for j in range(nr)]
        both = jnp.concatenate(parts, axis=1)        # (U, W + RW)
        cols = off[:, None] + lax.iota(jnp.int32, W)[None, :]
        return jnp.take_along_axis(both, cols, axis=1)

    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(spec, rep, rep), out_specs=rep,
        check_vma=False))


class _HostText:
    """Text access strategy: one process holds the whole text.

    Backs the convenience API — alphabet scan, repeat estimation, period
    verification and residue resolution all read the host copy."""

    can_materialize = True      # host int64 assembly allowed (wide)
    slice_output = True         # return arrays sliced to [:n]

    def __init__(self, text, mesh: Mesh):
        self.mesh = mesh
        self.P = int(mesh.devices.size)
        self.arr = as_byte_array(text)
        self.n = int(self.arr.shape[0])
        self.n_pad = bucket_size(self.n, multiple_of=self.P * 128)
        self.m = self.n_pad // self.P
        self.remap, _, _ = alphabet_remap(self.arr)
        self.est_repeat = estimate_repeat_len(self.arr)
        self.vals_d = jnp.asarray(
            np.flatnonzero(self.remap > 0).astype(np.uint8))
        text_pad = np.zeros(self.n_pad, np.uint8)
        text_pad[:self.n] = self.arr
        self.text_d = jax.device_put(text_pad, sequence_sharding(mesh))

    def feasible(self, words: int, cap: float, spw: int) -> bool:
        # Module-global lookup on purpose: tests monkeypatch
        # parallel.bigsort.residue_feasible to force the 3-word gate.
        return residue_feasible(self.arr, self.n, cap, self.est_repeat,
                                words=words, spw=spw)

    def fetch(self, x) -> np.ndarray:
        return np.asarray(jax.device_get(x))

    def period_holds(self, d: int) -> bool:
        return not np.any(self.arr[:-d] != self.arr[d:])

    def view(self):
        return self.arr       # _resolve_residue_host wraps it in _ArrView


class _GatheredView:
    """Bounded-window text view for residue resolution (multi-process).

    Serves the _ArrView contract (core/bigsort.py) from device window
    gathers: ``fetch`` batches one RESIDUE_WIN gather per call;
    ``suffix_less`` / ``suffix_lcp`` read DEEP_WIN-byte windows (cached,
    prefetchable) for the rare pairs equal through RESIDUE_WIN, and
    raise ResidueDepthError for ties deeper than DEEP_WIN — the caller
    turns that into the NotImplementedError doubling fallback."""

    DEEP_WIN = 4096

    def __init__(self, tops: "_DistText"):
        self.tops = tops
        self.n = tops.n
        self._deep: dict[int, np.ndarray] = {}

    def fetch(self, idxs: np.ndarray, K: int) -> np.ndarray:
        return self.tops.gather_windows(np.asarray(idxs, np.int64), K)

    def prefetch(self, idxs) -> None:
        missing = [int(i) for i in idxs if int(i) not in self._deep]
        if missing:
            win = self.tops.gather_windows(
                np.asarray(missing, np.int64), self.DEEP_WIN)
            for i, row in zip(missing, win):
                self._deep[i] = row

    def _rows(self, a: int, b: int):
        self.prefetch((a, b))
        return self._deep[a], self._deep[b]

    def suffix_less(self, a: int, b: int) -> bool:
        wa, wb = self._rows(int(a), int(b))
        neq = np.flatnonzero(wa != wb)
        if len(neq):
            t = int(neq[0])
            return bool(wa[t] < wb[t])
        # -1 marks past-end, so equal windows mean both suffixes extend
        # past DEEP_WIN (identical suffixes are impossible for a != b).
        raise ResidueDepthError(
            f"suffixes {a} and {b} tie past {self.DEEP_WIN} bytes")

    def suffix_lcp(self, a: int, b: int) -> int:
        wa, wb = self._rows(int(a), int(b))
        neq = np.flatnonzero(wa != wb)
        if len(neq):
            return int(neq[0])
        raise ResidueDepthError(
            f"suffixes {a} and {b} tie past {self.DEEP_WIN} bytes")


class _DistText:
    """Text access strategy: every process holds ONLY its local block.

    All global questions route through device collectives on the
    sharded text (histogram psum, shifted-compare period check, window
    gathers); per-process host work touches only the local block. Every
    host-side control decision derives from replicated device outputs,
    so all processes branch identically — the SPMD invariant."""

    can_materialize = False
    slice_output = False        # return PADDED sharded arrays

    def __init__(self, local_block: np.ndarray, n: int, mesh: Mesh):
        from jax.experimental import multihost_utils

        from hpc_suffix_array_tpu.parallel.multihost import (
            host_local_shard)

        self.mesh = mesh
        self.P = int(mesh.devices.size)
        self.n = n
        self.n_pad = bucket_size(n, multiple_of=self.P * 128)
        self.m = self.n_pad // self.P
        start, stop = host_local_shard(self.n_pad, mesh)
        if local_block.shape != (stop - start,):
            raise ValueError(
                f"local block shape {local_block.shape} != this "
                f"process's ({stop - start},) — size it with "
                "mp_local_geometry(n, mesh)")
        self.text_d = jax.make_array_from_process_local_data(
            sequence_sharding(mesh), np.ascontiguousarray(local_block),
            (self.n_pad,))
        pres = np.asarray(jax.device_get(_present_kernel(mesh)(
            self.text_d, jnp.int32(n // self.m), jnp.int32(n % self.m))))
        present = pres > 0
        self.remap = (np.cumsum(present) * present).astype(np.int32)
        self.vals_d = jnp.asarray(
            np.flatnonzero(self.remap > 0).astype(np.uint8))
        # Repeat estimate: per-process local estimate, allgathered max.
        # Local windows see any period shorter than the block, which is
        # all the router needs — a miss flips chain mode late via the
        # replicated tie stats (the misprediction retry), never wrongly.
        local_real = local_block[:max(0, min(stop, n) - start)]
        est = estimate_repeat_len(np.asarray(local_real))
        self.est_repeat = int(np.max(multihost_utils.process_allgather(
            np.asarray([est], np.int32))))
        self._allgather = multihost_utils.process_allgather

    def feasible(self, words: int, cap: float, spw: int) -> bool:
        from hpc_suffix_array_tpu.core.bigsort import (
            residue_feasible_sigma)

        sigma = max(int(self.remap.max()), 2)
        return residue_feasible_sigma(sigma, self.n, cap,
                                      self.est_repeat, words=words,
                                      spw=spw)

    def fetch(self, x) -> np.ndarray:
        # Sharded device array -> full host copy on EVERY process.
        return np.asarray(self._allgather(x, tiled=True))

    def period_holds(self, d: int) -> bool:
        bad = _period_kernel(self.mesh)(
            self.text_d, jnp.int32(d // self.m), jnp.int32(d % self.m),
            jnp.int32(self.n // self.m), jnp.int32(self.n % self.m))
        return int(jax.device_get(bad)) == 0

    def view(self):
        return _GatheredView(self)

    def gather_windows(self, idxs: np.ndarray, W: int) -> np.ndarray:
        """int16[len(idxs), W] suffix windows (-1 past end of text)."""
        L = len(idxs)
        U = bucket_size(max(L, 8))
        RW = min(W, self.m & -self.m)     # pow2, divides both m and W
        q = np.zeros(U, np.int32)
        off = np.zeros(U, np.int32)
        q[:L] = idxs // RW
        off[:L] = idxs % RW
        win = np.asarray(jax.device_get(
            _window_kernel(self.mesh, W, U, RW)(
                self.text_d, jnp.asarray(q), jnp.asarray(off))))[:L]
        rel = np.arange(W, dtype=np.int64)[None, :]
        return np.where(idxs[:, None] + rel < self.n,
                        win.astype(np.int16), np.int16(-1))


def wide_auto(n_pad: int) -> bool:
    """Auto-enable the two-word (hi, lo) index arithmetic when any
    padded index could reach int32's edge — the >=4 GiB ladder config.
    Executed at 2^29 (SA-IS byte-exact) on the virtual CPU mesh; past
    2^31 it has not run (host memory)."""
    return n_pad >= (1 << 31) - 1


def mp_local_geometry(n: int, mesh: Mesh) -> tuple[int, int, int]:
    """(n_pad, start, stop): padded text length for ``mesh`` and the
    [start, stop) block of it this process must pass to
    ``build_suffix_array_sharded_big_mp`` (zeros past n)."""
    from hpc_suffix_array_tpu.parallel.multihost import host_local_shard

    P = int(mesh.devices.size)
    n_pad = bucket_size(n, multiple_of=P * 128)
    start, stop = host_local_shard(n_pad, mesh)
    return n_pad, start, stop


def build_suffix_array_sharded_big(text, mesh: Mesh | None = None,
                                   force_chain_mode: bool | None = None,
                                   wide_index: bool | None = None,
                                   want_lcp: bool = False,
                                   device_columns: bool = False):
    """Suffix array of ``text`` via ONE distributed carried-keys sort.

    Returns the sharded int32[n] suffix array. Raises NotImplementedError
    on inputs whose tie structure exceeds the bounded residue and is not
    a clean periodic chain — callers fall back to
    ``build_suffix_array_sharded`` (the doubling path handles any skew).

    ``want_lcp``: also return the LCP array as ``(sa, lcp)`` — derived
    in-kernel from the sorted carried keys (adjacent xor+clz + the chain
    rule; residue patches for the bounded rest). This is the multi-host
    ladder config's LCP path: the distributed PLCP (parallel/lcp.py)
    runs several scan-class rounds, while this adds a few elementwise
    column passes to a sort the build already runs. Under ``wide_index`` the LCP is a
    two-word base-m pair like the SA itself (r2's NotImplementedError
    here is closed — see _local_build_wide).

    ``wide_index``: two-word (hi, lo) global indices for texts past the
    int32 range — the >=4 GiB ladder config (BASELINE.md). Auto-enabled
    when n (plus padding) nears 2^31; forcible for tests. By default
    wide builds materialize HOST int64[n] arrays (convenience API);
    ``device_columns=True`` instead returns the device-resident sharded
    int32[n_pad] base-m column pairs ``(sa_hi, sa_lo)`` (and
    ``(lcp_hi, lcp_lo)`` with want_lcp), g = hi * m + lo with
    m = n_pad // len(mesh): the production multi-host form — nothing
    n-sized crosses to the host, residue patches apply per shard on
    device (_patch_kernel).

    This entry assumes the calling process holds the whole ``text``
    (the reference's own model, src/mpi/main_mpi.c:25-37). When no
    process does, use ``build_suffix_array_sharded_big_mp``.
    """
    if mesh is None:
        mesh = make_mesh()
    arr = as_byte_array(text)
    if int(arr.shape[0]) < 8:
        raise ValueError("sharded bigsort needs n >= 8; use the doubling "
                         "builder")
    tops = _HostText(arr, mesh)
    return _build(tops, force_chain_mode, wide_index, want_lcp,
                  device_columns)


def build_suffix_array_sharded_big_mp(local_block, n: int,
                                      mesh: Mesh | None = None,
                                      force_chain_mode: bool | None = None,
                                      wide_index: bool | None = None,
                                      want_lcp: bool = False):
    """Multi-process one-pass MSD build: NO process holds the full text.

    Each process passes only its own block of the padded text —
    ``mp_local_geometry(n, mesh)`` gives the [start, stop) range; bytes
    past n are zeros. Alphabet and repeat estimation, chain-period
    verification, and residue resolution all run through device
    collectives on the sharded text (see _DistText); every host-side
    branch decision reads replicated device outputs, so all processes
    stay in lockstep.

    Returns PADDED sharded device arrays (rows [0, n) are the result;
    pad rows of the narrow sa hold n): narrow ``sa`` (int32[n_pad]) or
    ``(sa, lcp)``; wide always the device-resident base-m column pairs
    ``(sa_hi, sa_lo)`` / ``((sa_hi, sa_lo), (lcp_hi, lcp_lo))``.

    Raises NotImplementedError on irregular massive ties (including
    residue pairs tied past the 4096-byte gather window) — callers fall
    back to the doubling builder, whose multi-process form is
    ``parallel.doubling`` over ``put_sharded_text``.

    Ref: the reference's multi-process build broadcasts the whole text
    to every rank (src/mpi/main_mpi.c:43-51); this one feeds each
    process its block and never re-assembles the text anywhere.
    """
    if mesh is None:
        mesh = make_mesh()
    if int(n) < 8:
        raise ValueError("sharded bigsort needs n >= 8; use the doubling "
                         "builder")
    tops = _DistText(np.asarray(local_block, np.uint8), int(n), mesh)
    try:
        return _build(tops, force_chain_mode, wide_index, want_lcp,
                      device_columns=True)
    except ResidueDepthError as e:
        raise NotImplementedError(
            f"sharded bigsort[mp]: {e} - use the doubling builder") from e


def _build(tops, force_chain_mode, wide_index, want_lcp, device_columns):
    """Shared orchestration over a text-access strategy (tops)."""
    n, P = tops.n, tops.P
    bits, spw, minpad = packing_mode(tops.remap)
    ranges = byte_ranges(tops.remap)
    # Carried word count: 2, or 3 when the 2-word expected residue
    # overflows the mesh-wide extraction budget but 3 words' fits (small
    # alphabets at scale — DNA past ~2^26; core _direct_sort3 rationale,
    # sharded). Periodic texts stay at 2 (chain rule needs no cap).
    cap_total = P * RESIDUE_SLOTS / 4
    nw = 2
    if not tops.feasible(2, cap_total, spw):
        if tops.feasible(3, cap_total, spw):
            nw = 3
    chain = force_chain_mode
    if chain is None:
        chain = tops.est_repeat > nw * spw
    if wide_index is None:
        wide_index = wide_auto(tops.n_pad)
    if wide_index:
        return _build_wide(tops, bits, spw, minpad, ranges, nw, chain,
                           force_chain_mode, want_lcp, device_columns)
    return _build_narrow(tops, bits, spw, minpad, ranges, nw, chain,
                         force_chain_mode, want_lcp, device_columns)


def _build_narrow(tops, bits, spw, minpad, ranges, nw, chain,
                  force_chain_mode, want_lcp, device_columns):
    mesh, n, P, m = tops.mesh, tops.n, tops.P, tops.m

    kern = _kernels(mesh, bits, spw, ranges, nw, minpad)
    s_idx, lcp_d, slots, res_idx, stats = kern(
        tops.text_d, tops.vals_d, jnp.int32(n), jnp.bool_(chain))
    st = np.asarray(jax.device_get(stats))           # replicated
    tie_cnt, dmax, dmin = int(st[0]), int(st[1]), int(st[2])

    def finish(sa_pad, lcp_pad):
        if want_lcp and minpad:
            lcp_pad = _clamp_lcp(sa_pad, lcp_pad, jnp.int32(n))
        if tops.slice_output:
            sa_pad = sa_pad[:n]
            if want_lcp:
                lcp_pad = lcp_pad[:n]
        return (sa_pad, lcp_pad) if want_lcp else sa_pad

    if chain:
        if tie_cnt:
            delta_ok = (dmin == dmax) and dmax >= 1
            if not delta_ok:
                if force_chain_mode is None and tie_cnt <= n // 4:
                    return _build(tops, False, False, want_lcp,
                                  device_columns)
                raise NotImplementedError(
                    "sharded bigsort: residual ties are not uniform "
                    "arithmetic chains - use the doubling builder")
            d = dmax
            if d and not tops.period_holds(d):
                if force_chain_mode is None and tie_cnt <= n // 4:
                    # Uniform deltas that are NOT a global period (e.g.
                    # a min-symbol tail run under minpad packing, or one
                    # long repeated block): ascending + residue handles
                    # the bounded ties; chain mode was a misprediction
                    # (mirrors core execute_big).
                    return _build(tops, False, False, want_lcp,
                                  device_columns)
                raise NotImplementedError(
                    f"sharded bigsort: chain delta {d} is not a global "
                    "period - use the doubling builder")
        return finish(s_idx, lcp_d)

    if tie_cnt > n // 4 and force_chain_mode is None:
        return _build(tops, True, False, want_lcp, device_columns)
    if st[4]:
        raise NotImplementedError(
            "sharded bigsort: window-tied elements exceed the per-shard "
            "residue cap - use the doubling builder")

    if tie_cnt:
        slots_h = tops.fetch(slots)
        idx_h = tops.fetch(res_idx)
        keep = slots_h >= 0
        if keep.any():
            s_sorted, fixed, ls, lv = _resolve_residue_host(
                tops.view(), slots_h[keep].astype(np.int64), idx_h[keep],
                n, want_lcp=want_lcp)
            ok = s_sorted < n          # pads never join groups, but guard
            patch = _patch_kernel(mesh)
            R = RESIDUE_SLOTS
            ps, pv = _group_patches(s_sorted[ok], fixed[ok], P, m, R)
            s_idx = patch(s_idx, jnp.asarray(ps), jnp.asarray(pv))
            if want_lcp and len(ls):
                ok_l = ls < n
                ps, pv = _group_patches(ls[ok_l], lv[ok_l], P, m, R)
                lcp_d = patch(lcp_d, jnp.asarray(ps), jnp.asarray(pv))
    return finish(s_idx, lcp_d)


def _group_patches(slots_g, vals, P: int, m: int, R: int):
    """Group global-slot patches by owning shard into (P*R,) padded
    int32 (local slot, value) arrays for the shard_map patch kernel."""
    out_s = np.full(P * R, -1, np.int32)
    out_v = np.zeros(P * R, np.int32)
    sh = (slots_g // m).astype(np.int64)
    loc = (slots_g % m).astype(np.int32)
    for p_ in range(P):
        idx = np.flatnonzero(sh == p_)
        assert len(idx) <= R, "per-shard residue cap violated"
        out_s[p_ * R:p_ * R + len(idx)] = loc[idx]
        out_v[p_ * R:p_ * R + len(idx)] = vals[idx]
    return out_s, out_v


def _build_wide(tops, bits, spw, minpad, ranges, nw, chain,
                force_chain_mode, want_lcp, device_columns):
    """Wide-index (two-word) sharded build.

    ``device_columns=False`` (default, _HostText only): host int64[n]
    arrays (sa, and lcp when ``want_lcp``) — the convenience API.
    ``device_columns=True``: the device-resident sharded int32[n_pad]
    base-m column pairs ``(sa_hi, sa_lo)`` (and ``(lcp_hi, lcp_lo)``),
    valid in the first n rows, g = hi * m + lo with m = n_pad // P —
    the production multi-host form: nothing n-sized ever crosses to the
    host, and the residue patch is applied per shard on device
    (_patch_kernel)."""
    mesh, n, P, m = tops.mesh, tops.n, tops.P, tops.m
    if not device_columns and not tops.can_materialize:
        raise ValueError("multi-process wide builds are device-columns "
                         "only (no process can hold int64[n])")

    kern = _kernels_wide(mesh, bits, spw, ranges, nw, minpad)
    s_hi, s_lo, lcp_hi, lcp_lo, slot_lo, res_hi, res_lo, stats = kern(
        tops.text_d, tops.vals_d, jnp.int32(n // m), jnp.int32(n % m),
        jnp.bool_(chain))
    st = np.asarray(jax.device_get(stats))           # replicated
    tie_cnt = int(st[0])
    dmax_hi, dmin_hi, dmax_lo, dmin_lo = (int(x) for x in st[1:5])

    def materialize():
        if device_columns:
            cols_l = (lcp_hi, lcp_lo)
            if want_lcp and minpad:
                # Final two-word length clamp over the (possibly
                # patched) columns — see _clamp_kernel_wide.
                cols_l = _clamp_kernel_wide(mesh)(
                    s_hi, s_lo, lcp_hi, lcp_lo, jnp.int32(n // m),
                    jnp.int32(n % m))
            sa_cols = (s_hi, s_lo)
            return ((sa_cols, cols_l) if want_lcp else sa_cols)
        sa = (np.asarray(jax.device_get(s_hi)).astype(np.int64) * m
              + np.asarray(jax.device_get(s_lo)))[:n]
        if not want_lcp:
            return sa
        lcp = (np.asarray(jax.device_get(lcp_hi)).astype(np.int64) * m
               + np.asarray(jax.device_get(lcp_lo)))[:n]
        return sa, lcp

    def np_clamp(sa, lcp):
        """Host counterpart of the final minpad length clamp (applied
        AFTER any numpy residue patch — see core _clamp_lcp)."""
        prev = np.concatenate([sa[:1], sa[:-1]])
        return np.minimum(lcp, n - np.maximum(prev, sa))

    def finish():
        out = materialize()
        if not (want_lcp and minpad) or device_columns:
            return out
        sa, lcp = out
        return sa, np_clamp(sa, lcp)

    if chain:
        if tie_cnt:
            uniform = (dmax_hi == dmin_hi) and (dmax_lo == dmin_lo)
            d = dmax_hi * m + dmax_lo
            if not uniform or d < 1:
                if force_chain_mode is None and tie_cnt <= n // 4:
                    return _build(tops, False, True, want_lcp,
                                  device_columns)
                raise NotImplementedError(
                    "sharded bigsort[wide]: residual ties are not "
                    "uniform arithmetic chains - use the doubling "
                    "builder")
            if not tops.period_holds(d):
                if force_chain_mode is None and tie_cnt <= n // 4:
                    # Misprediction fallback — see the narrow branch.
                    return _build(tops, False, True, want_lcp,
                                  device_columns)
                raise NotImplementedError(
                    f"sharded bigsort[wide]: chain delta {d} is not a "
                    "global period - use the doubling builder")
        return finish()

    if tie_cnt > n // 4 and force_chain_mode is None:
        return _build(tops, True, True, want_lcp, device_columns)
    if st[6]:
        raise NotImplementedError(
            "sharded bigsort[wide]: window-tied elements exceed the "
            "per-shard residue cap - use the doubling builder")

    if tie_cnt:
        # Shard s's slot block is local; globalize with s * m.
        slots_h = tops.fetch(slot_lo).astype(np.int64)
        shard_of = np.repeat(np.arange(P, dtype=np.int64), RESIDUE_SLOTS)
        keep = slots_h >= 0
        slots_g = slots_h[keep] + shard_of[keep] * m
        idx_g = (tops.fetch(res_hi).astype(np.int64) * m
                 + tops.fetch(res_lo))[keep]
        if keep.any():
            s_sorted, fixed, ls, lv = _resolve_residue_host(
                tops.view(), slots_g, idx_g, n, want_lcp=want_lcp)
            ok = s_sorted < n
            if device_columns:
                patch = _patch_kernel(mesh)
                R = RESIDUE_SLOTS
                ps, pv = _group_patches(s_sorted[ok], fixed[ok] // m,
                                        P, m, R)
                s_hi = patch(s_hi, jnp.asarray(ps), jnp.asarray(pv))
                ps, pv = _group_patches(s_sorted[ok], fixed[ok] % m,
                                        P, m, R)
                s_lo = patch(s_lo, jnp.asarray(ps), jnp.asarray(pv))
                if want_lcp and len(ls):
                    ok_l = ls < n
                    ps, pv = _group_patches(ls[ok_l], lv[ok_l] // m,
                                            P, m, R)
                    lcp_hi = patch(lcp_hi, jnp.asarray(ps),
                                   jnp.asarray(pv))
                    ps, pv = _group_patches(ls[ok_l], lv[ok_l] % m,
                                            P, m, R)
                    lcp_lo = patch(lcp_lo, jnp.asarray(ps),
                                   jnp.asarray(pv))
            else:
                out = materialize()
                sa, lcp = out if want_lcp else (out, None)
                sa[s_sorted[ok]] = fixed[ok]
                if want_lcp and len(ls):
                    ok_l = ls < n
                    lcp[ls[ok_l]] = lv[ok_l]
                if want_lcp and minpad:
                    lcp = np_clamp(sa, lcp)
                return (sa, lcp) if want_lcp else sa
    return finish()
