"""Benchmark-scale LCP: chunked adjacent-window comparison.

``lcp[j] = LCP(suffix sa[j-1], suffix sa[j])`` is computed directly: the
chunk program gathers each suffix's next ``depth`` bytes ONCE (as packed
int32 WORDS — gathers were priced per element regardless of element
width on an earlier accelerator, so word fetches were 4x cheaper than
byte fetches), realigns them byte-wise, and takes the first mismatch of
each adjacent pair (a masked reduce-min). No scan ops, no lax.map: the
program stays in the sort/gather class, which an earlier remote compiler
handled in minutes where the PLCP round's associative scans took hours
(host workaround, to be re-justified on the GPU host, ROADMAP D2).

``depth`` adapts to the alphabet (~2 log_sigma n + slack), so window
misses (adjacent LCP >= depth) are rare on low-repeat texts. They are
finished by:

  1. the periodic-chain rule when the text is globally d-periodic
     (unresolved pairs are chain neighbors: suffix sa[j] is suffix
     sa[j-1] extended by one period, so lcp[j] = n - sa[j-1] exactly —
     the same theorem as core/bigsort chain mode), verified by a
     period sweep;
  2. a host-side direct comparison for a bounded residue of irregular
     pairs (capped; beyond the cap the text belongs to the PLCP path).

Reference contract parity: src/sequential/manber_myers.c:135-157 (Kasai)
— same output, different algorithm, validated against the Kasai oracles.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from hpc_suffix_array_tpu.core.suffix_array import as_byte_array, bucket_size

HOST_FINISH_CAP = 65536    # irregular window-miss pairs finished on host
CHUNK = 1 << 20


def pick_depth(n: int, sigma: int) -> int:
    """Window depth in bytes (multiple of 4): ~2 log_sigma n + slack."""
    if sigma < 2:
        return 64
    need = 2 * math.log(max(n, 2), sigma) + 10
    return int(min(64, max(16, 4 * math.ceil(need / 4))))


def _sym_windows(text32, idx, depth: int, n):
    """(P, depth) symbol matrix via ONE word gather per element.

    Fetches depth//4 + 1 int32 words per suffix and realigns byte-wise
    (idx & 3 selects among 4 static shift patterns). Symbols are byte+1,
    0 past the end."""
    nw = depth // 4 + 1
    words = text32[(idx >> 2)[:, None]
                   + jnp.arange(nw, dtype=jnp.int32)]     # (P, nw)
    off = (idx & 3)[:, None]                               # (P, 1)
    syms = []
    for j in range(depth):
        variants = []
        for o in range(4):
            w = words[:, (o + j) // 4]
            variants.append((w >> (((o + j) % 4) * 8)) & 255)
        b = jnp.where(
            off[:, 0] == 0, variants[0],
            jnp.where(off[:, 0] == 1, variants[1],
                      jnp.where(off[:, 0] == 2, variants[2], variants[3])))
        syms.append(b)
    mat = jnp.stack(syms, axis=1)                          # (P, depth)
    pos = idx[:, None] + jnp.arange(depth, dtype=jnp.int32)
    return jnp.where(pos < n, mat + 1, 0)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _lcp_chunk(depth: int, P: int, text32, sa_ext, start, n):
    """First-mismatch offsets for pairs (sa[start+p-1], sa[start+p]).

    ``sa_ext`` is sa prefixed with its own first element, so one
    (P+1)-row window fetch serves both sides of every pair. Pairs with
    no mismatch inside the window report ``depth``."""
    idx = lax.dynamic_slice(sa_ext, (start,), (P + 1,))
    mat = _sym_windows(text32, idx, depth, n)
    neq = mat[:-1] != mat[1:]
    j = jnp.arange(depth, dtype=jnp.int32)
    return jnp.min(jnp.where(neq, j, depth), axis=1)


@functools.partial(jax.jit, static_argnums=(0,))
def _chain_fix(depth: int, sa, lcp, n, d):
    """lcp[j] = n - sa[j-1] for unresolved chain-neighbor pairs
    (sa[j-1] == sa[j] + d, d a verified global period).
    Returns (lcp, residual_unresolved_count)."""
    prev = jnp.concatenate([sa[:1], sa])[:-1]
    unresolved = lcp >= depth
    chain = unresolved & (prev - sa == d)
    lcp = jnp.where(chain, n - prev, lcp)
    return lcp, jnp.sum((unresolved & ~chain).astype(jnp.int32))


@functools.partial(jax.jit, static_argnums=(0,))
def _unresolved_stats(depth: int, sa, lcp):
    """(count, dmax, dmin) over unresolved pairs' deltas — scalars only,
    so the common periodic case needs no bulk device->host transfer."""
    prev = jnp.concatenate([sa[:1], sa])[:-1]
    unres = (lcp >= depth).at[0].set(False)
    delta = jnp.where(unres, prev - sa, 0)
    big = jnp.int32(1) << 30
    return (jnp.sum(unres.astype(jnp.int32)),
            jnp.max(jnp.where(unres, delta, 0)),
            jnp.min(jnp.where(unres, delta, big)))


@jax.jit
def _pack_words(text_bytes):
    """Device-side little-endian int32 word packing of a byte array
    (length must be a multiple of 4) — avoids a second host upload."""
    b = text_bytes.reshape(-1, 4).astype(jnp.int32)
    return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)


def prepare_lcp(text) -> dict:
    """Stage the text for repeated window-LCP runs (bench staged form)."""
    arr = as_byte_array(text)
    n = int(arr.shape[0])
    sigma = int((np.bincount(arr[:1 << 22], minlength=256) > 0).sum())
    depth = pick_depth(n, sigma)
    P = min(CHUNK, bucket_size(max(n, 1)))
    n_chunks = -(-n // P) if n else 0
    from hpc_suffix_array_tpu.utils.staging import stage_to_device

    nbytes = n_chunks * P + depth + 8
    host = np.zeros(-(-nbytes // 4) * 4, np.uint8)
    host[:n] = np.asarray(arr)
    text_dev = stage_to_device(host)      # chunked upload; words packed on device
    return {"arr": arr, "n": n, "depth": depth, "P": P,
            "n_chunks": n_chunks, "text_dev": text_dev,
            "text32": _pack_words(text_dev)}


def build_lcp_array_window(text, sa, state: dict | None = None
                           ) -> jnp.ndarray:
    """LCP array for large texts (see module docstring)."""
    if state is None:
        state = prepare_lcp(text)
    arr, n = state["arr"], state["n"]
    depth, P, n_chunks = state["depth"], state["P"], state["n_chunks"]
    text32, text_dev = state["text32"], state["text_dev"]
    if n == 0:
        return jnp.zeros((0,), jnp.int32)
    sa = jnp.asarray(sa, jnp.int32)

    sa_pad = jnp.concatenate(
        [sa, jnp.full((n_chunks * P - n,), n, jnp.int32)])
    sa_ext = jnp.concatenate([sa_pad[:1], sa_pad])

    pieces = [
        _lcp_chunk(depth, P, text32, sa_ext, jnp.int32(c * P), jnp.int32(n))
        for c in range(n_chunks)
    ]
    lcp = jnp.concatenate(pieces)[:n]
    lcp = lcp.at[0].set(0)
    return _finish_misses(arr, text_dev, sa, lcp, depth, n)


def _finish_misses(arr, text_dev, sa, lcp, depth: int, n: int):
    """Resolve window misses (lcp >= depth): chain rule, then host residue.

    Shared tail of the gather-window and sorted-fetch paths; ``text_dev``
    is the zero-padded device byte array used for the period sweep."""
    total_miss = int(jax.device_get(
        jnp.sum((lcp[1:] >= depth).astype(jnp.int32))))   # ONE sync

    if total_miss == 0:
        return lcp

    # Periodic-chain analytic fix: decided with SCALAR syncs only (the
    # periodic case would otherwise pay two full-array fetches).
    from hpc_suffix_array_tpu.core.bigsort import _period_mismatches

    cnt, dmax, dmin = (int(x) for x in jax.device_get(
        _unresolved_stats(depth, sa, lcp)))
    d = dmax if (cnt and dmax == dmin and dmax > 0) else 0
    if d > 0:
        mm = int(jax.device_get(_period_mismatches(
            text_dev, jnp.int32(d), jnp.int32(n))))
        if mm == 0:
            lcp, residual = _chain_fix(
                depth, sa, lcp, jnp.int32(n), jnp.int32(d))
            if int(jax.device_get(residual)) == 0:
                return lcp

    # Irregular residue: bounded bulk fetch + host finish.
    lcp_np = np.array(jax.device_get(lcp))
    sa_np = np.asarray(jax.device_get(sa))
    prev_np = np.concatenate([sa_np[:1], sa_np])[:-1]
    unresolved_idx = np.flatnonzero(lcp_np >= depth)
    unresolved_idx = unresolved_idx[unresolved_idx > 0]

    # Host finish for the bounded irregular residue.
    if len(unresolved_idx) > HOST_FINISH_CAP:
        raise NotImplementedError(
            f"{len(unresolved_idx)} adjacent pairs exceed the {depth}-byte "
            "window and are not a global period - use the PLCP path "
            "(raise SA_LCP_WINDOW_MIN) or the sharded LCP builder")
    arr_np = np.asarray(arr)
    for j in unresolved_idx:
        a, b = int(prev_np[j]), int(sa_np[j])
        lim = n - max(a, b)
        wa, wb = arr_np[a:a + lim], arr_np[b:b + lim]
        neq = np.flatnonzero(wa != wb)
        lcp_np[j] = int(neq[0]) if len(neq) else lim
    return jnp.asarray(lcp_np)


# ---------------------------------------------------------------------------
# Sorted-fetch path: permute packed key words into SA order by sort.
#
# The gather-window path above pays per gathered ELEMENT —
# n * (depth/4 + 1) word fetches dominate its runtime (gather-bound on
# an earlier accelerator). This path fetches NOTHING: each suffix's first
# WN*spw symbols are packed into WN int32 words in TEXT order (static
# shifted slices, fused), then carried into SA order by two lax.sort
# calls (sa -> inverse permutation; isa-keyed payload sort). Adjacent
# first-mismatch falls out of xor + count-leading-zeros on the word
# columns. Sorts were far cheaper than gathers of the same coverage on
# an earlier accelerator (not re-measured on the GPU, ROADMAP D3), and
# the packing reuses core/bigsort's dense
# alphabet machinery, so window depth ADAPTS to the alphabet: 2*spw
# symbols per word pair (alnum 10, DNA 20, binary 30 at WN=2).
# ---------------------------------------------------------------------------


def _pick_wn(n: int, sigma: int, spw: int) -> int:
    """Number of packed key words so expected adjacent-pair misses stay
    in the host-finish regime: sigma^(WN*spw) >> n^2 (misses ~ number of
    repeated (WN*spw)-grams). Periodic texts miss regardless and take
    the chain rule instead."""
    import math as _m

    lg_sigma = _m.log2(max(sigma, 2))
    need_syms = (2 * _m.log2(max(n, 2)) + 10) / lg_sigma
    return int(min(4, max(2, _m.ceil(need_syms / max(spw, 1)))))


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 7))
def _mismatch_sorted(WN: int, spw: int, bits: int, text_ext, vals,
                     sa_pad, n, ranges=None):
    """First-mismatch offsets (int32[n_pad]) for adjacent SA pairs.

    ``text_ext`` is uint8[n_pad + WN*spw] zero past n; ``sa_pad`` is sa
    extended with n..n_pad-1 (unique keys that sort to the tail). Pairs
    with no mismatch inside WN*spw symbols report WN*spw. Entry 0 and
    pad entries report 0. ONE dispatch, no gathers, no scans."""
    n_pad = sa_pad.shape[0]
    depth = WN * spw
    # Dense codes without a table gather (core/bigsort.codes_from_bytes:
    # static piecewise ranges, or compare-sum over present values).
    from hpc_suffix_array_tpu.core.bigsort import codes_from_bytes

    pos_ext = lax.iota(jnp.int32, n_pad + depth)
    codes = codes_from_bytes(text_ext, vals, ranges)
    codes = jnp.where(pos_ext < n, codes, 0)
    kws = [_dev_pack_word_local(codes, w * spw, spw, bits, n_pad)
           for w in range(WN)]
    # Permute words into SA order: sort 1 builds the inverse permutation
    # (isa[i] = position of suffix i in sa); sort 2 keyed by isa lands
    # payload kw[i] at output slot isa[i], i.e. out[r] = kw[sa[r]].
    iota = lax.iota(jnp.int32, n_pad)
    # Unstable: both sort keys are permutations (sa over real slots; isa
    # always, by construction), so stability buys nothing.
    _, isa = lax.sort((sa_pad, iota), num_keys=1, is_stable=False)
    srt = lax.sort((isa, *kws), num_keys=1, is_stable=False)
    kws_sa = srt[1:]
    # Adjacent compare: first differing symbol via xor + clz. Packed
    # words hold spw symbols in their low spw*bits bits, first symbol
    # highest; highest set xor bit p => symbol spw-1 - p//bits.
    offs = []
    for w, kw in enumerate(kws_sa):
        prev = jnp.concatenate([kw[:1], kw[:-1]])
        x = prev ^ kw
        sym = spw - 1 - (31 - lax.clz(x)) // bits
        offs.append(jnp.where(x != 0, w * spw + sym, depth))
    lcp = jnp.min(jnp.stack(offs), axis=0)
    real = (iota >= 1) & (iota < n)
    return jnp.where(real, lcp, 0)


def _dev_pack_word_local(codes_ext, offset: int, spw: int, bits: int,
                         m: int):
    """Packed word of spw codes from element ``offset`` (static fold)."""
    out = jnp.zeros((m,), jnp.int32)
    for s in range(spw):
        out = (out << bits) | lax.slice(
            codes_ext, (offset + s,), (offset + s + m,))
    return out


def prepare_lcp_sorted(text, text_pad_dev=None) -> dict:
    """Stage the text for repeated sorted-fetch LCP runs.

    ``text_pad_dev``: optional device copy of the text padded to
    ``bucket_size(n)`` with zeros past n (e.g. bench.py's twin corpus);
    skips the host->device transfer — the word-window extension is
    appended on device."""
    from hpc_suffix_array_tpu.core.suffix_array import alphabet_remap

    arr = as_byte_array(text)
    n = int(arr.shape[0])
    remap, bits, _h0 = alphabet_remap(arr) if n else (
        np.zeros(256, np.int32), 1, 1)
    sigma = int(remap.max()) if n else 1
    spw = max(1, 30 // bits)
    wn = _pick_wn(n, sigma, spw)
    n_pad = bucket_size(max(n, 1))
    if text_pad_dev is not None and tuple(text_pad_dev.shape) == (n_pad,):
        text_ext = jnp.concatenate(
            [text_pad_dev, jnp.zeros(wn * spw, jnp.uint8)])
    else:
        from hpc_suffix_array_tpu.utils.staging import stage_to_device

        host = np.zeros(n_pad + wn * spw, np.uint8)
        host[:n] = np.asarray(arr)
        text_ext = stage_to_device(host)
    from hpc_suffix_array_tpu.core.bigsort import byte_ranges

    return {"arr": arr, "n": n, "spw": spw, "bits": bits, "wn": wn,
            "text_ext": text_ext, "ranges": byte_ranges(remap),
            "vals": jnp.asarray(np.flatnonzero(remap > 0).astype(np.uint8))}


def build_lcp_array_sorted(text, sa, state: dict | None = None
                           ) -> jnp.ndarray:
    """LCP array for large texts, sorted-fetch strategy (see above)."""
    if state is None:
        state = prepare_lcp_sorted(text)
    arr, n = state["arr"], state["n"]
    if n == 0:
        return jnp.zeros((0,), jnp.int32)
    wn, spw, bits = state["wn"], state["spw"], state["bits"]
    depth = wn * spw
    n_pad = state["text_ext"].shape[0] - depth
    sa = jnp.asarray(sa, jnp.int32)
    sa_pad = jnp.concatenate(
        [sa, jnp.arange(n, n_pad, dtype=jnp.int32)]) if n_pad > n else sa
    lcp = _mismatch_sorted(wn, spw, bits, state["text_ext"], state["vals"],
                           sa_pad, jnp.int32(n), state.get("ranges"))[:n]
    return _finish_misses(arr, state["text_ext"], sa, lcp, depth, n)
