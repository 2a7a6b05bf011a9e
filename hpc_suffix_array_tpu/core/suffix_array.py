"""Suffix-array construction by Manber-Myers prefix doubling, on device.

Behavioral parity target: reference ``build_suffix_array``
(src/sequential/manber_myers.c:81-133) - byte ranks at k=1
(manber_myers.c:88-92), doubling loop ``k = 2, 4, ...`` bounded by ``2n``
(manber_myers.c:97), dense re-rank (manber_myers.c:101-110), and early
termination the moment all ranks are distinct (manber_myers.c:113).
The suffix array of a text is unique, so output equality with the reference
is exact by construction.

Design differences (data-parallel, not a translation):
  * struct-of-arrays: three int32 vectors (rank, rank_k, idx) instead of an
    array of ``Suffix`` structs - keeps data in wide vector-friendly layout.
  * one jitted ``lax.while_loop`` carries (rank, k, max_rank, sa); the round
    count is dynamic on device, there is no host round-trip per round and no
    retrace (the reference re-runs a host loop per round).
  * bytes are ranked unsigned (0..255). The reference seeds ranks from
    ``char`` (signed on x86, manber_myers.c:90) but validates with strcmp's
    unsigned order (manber_myers.c:195) - inconsistent for bytes >= 128; we
    use the strcmp (true lexicographic) order everywhere.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from hpc_suffix_array_tpu.ops.scan import dense_ranks, route_to_positions
from hpc_suffix_array_tpu.ops.shift import shifted_ranks
from hpc_suffix_array_tpu.ops.sort import sort_by_rank_pairs


# Prefix-multiplication factor per round: rank covers FACTOR*h symbols
# after a round keyed on (rank[i], rank[i+h], ..., rank[i+(FACTOR-1)h]).
# The reference doubles (FACTOR=2, manber_myers.c:97); tripling uses the
# same sort machinery with one extra key column but log3 instead of log2
# rounds — a ~1.6x round-count cut on periodic texts, where round count
# is the whole cost (k must exceed the period before ranks separate).
# FACTOR=3 tripled XLA compile time for the big shapes on an earlier
# accelerator, so the default stays 2 until its cost on the GPU is
# measured; the machinery is FACTOR-generic.
FACTOR = 2


def _doubling_round(rank, k, idx):
    """One prefix-multiplication round: multi-key sort + dense re-rank.

    Returns (new_rank, max_rank, sorted_idx) where sorted_idx is the
    suffix order under the (rank[i], rank[i+k], ..., rank[i+(F-1)k])
    key. When the round converges (all ranks distinct) the route back to
    position order is skipped — new_rank is never read again, and on
    random text that final-round permutation is 30-50% of the build.
    """
    shifts = [shifted_ranks(rank, j * k) for j in range(1, FACTOR)]
    # Unstable: dense re-rank is value-based (equal key tuples get equal
    # ranks whatever their order) and the returned s_idx only becomes
    # the SA on the converged round, where all keys are distinct — tie
    # order inside intermediate rounds is unobservable, so stability
    # would be paid for nothing.
    sorted_cols = lax.sort((rank, *shifts, idx), num_keys=FACTOR,
                           is_stable=False)
    s_idx = sorted_cols[-1]
    dense, max_rank = dense_ranks_multi(sorted_cols[:-1])
    n = rank.shape[0]
    new_rank = lax.cond(
        max_rank >= n - 1,
        lambda: rank,
        lambda: route_to_positions(s_idx, dense))
    return new_rank, max_rank, s_idx


def dense_ranks_multi(sorted_keys):
    """dense_ranks generalized to a tuple of key columns."""
    bumps = None
    for col in sorted_keys:
        prev = jnp.concatenate([col[:1], col[:-1]])
        b = col != prev
        bumps = b if bumps is None else (bumps | b)
    bumps = bumps.at[0].set(False)
    dense = jnp.cumsum(bumps.astype(jnp.int32))
    return dense, dense[-1]


# Bit budget for the packed initial rank code (must stay positive int32).
PACK_BITS = 30


@jax.jit
def suffix_array_kernel(rank0: jnp.ndarray, k0: jnp.ndarray):
    """Compute the suffix order for initial ranks ``rank0`` (int32[n], n >= 1).

    ``rank0`` is the packed order-preserving code of the ``k0``-symbol
    prefix of each suffix (see ``pack_initial_ranks``): pad positions code
    to 0, which ranks below every real prefix, so all pad suffixes sort
    first and the real suffix array is the tail slice (see
    ``build_suffix_array``). ``k0`` is dynamic so texts with different
    alphabet sizes share one compiled program.

    Returns:
      sa:     int32[n] suffix order (sa[j] = start of j-th smallest suffix).
      rank:   int32[n] dense ranks as of the round BEFORE the converging
              one - the converging round skips the route back to position
              order (see _doubling_round), so this is NOT the inverse SA;
              it is internal state exposed for diagnostics only.
      rounds: int32 number of doubling rounds executed.
    """
    n = rank0.shape[0]
    idx = lax.iota(jnp.int32, n)

    def cond(carry):
        _rank, k, max_rank, _sa, rounds = carry
        # At least one round always runs: with a packed k0 the first sort
        # may already cover the whole text (k0 >= 2n for tiny inputs), but
        # the initial carry's sa is the unsorted iota.
        return (rounds == 0) | ((max_rank < n - 1) & (k < 2 * n))

    def body(carry):
        rank, k, _max_rank, _sa, rounds = carry
        new_rank, max_rank, s_idx = _doubling_round(rank, k, idx)
        return new_rank, k * FACTOR, max_rank, s_idx, rounds + 1

    init = (rank0, jnp.asarray(k0, jnp.int32), jnp.int32(-1), idx,
            jnp.int32(0))
    rank, _k, _max_rank, sa, rounds = lax.while_loop(cond, body, init)
    return sa, rank, rounds


def alphabet_remap(arr: np.ndarray) -> tuple[np.ndarray, int, int]:
    """Dense alphabet codes for adaptive packing (host, one bincount pass).

    Returns (remap int32[256] mapping byte -> code in 1..K, bits, h0):
    each symbol takes bits = ceil(log2(K+1)) bits and h0 = PACK_BITS//bits
    symbols pack into one int32 initial rank - so small alphabets start
    the doubling loop much later (DNA: h0 = 10; binary: h0 = 15; full
    bytes: h0 = 3). The reference always starts from single chars
    (manber_myers.c:88-92).
    """
    # Chunked bincount: np.bincount casts its input to int64 internally,
    # i.e. an 8x full-text temp (8.6 GB at 1 GiB). 16 MiB chunks bound
    # the temp to 128 MB, reused hot across iterations.
    counts = np.zeros(256, np.int64)
    step = 1 << 24
    for i in range(0, arr.size, step):
        counts += np.bincount(arr[i:i + step], minlength=256)
    present = counts > 0
    remap = np.cumsum(present).astype(np.int32) * present
    k = int(remap.max()) if arr.size else 1
    bits = max(1, int(k).bit_length())
    h0 = max(1, PACK_BITS // bits)
    return remap, bits, h0


@jax.jit
def _presence_kernel(text_dev: jnp.ndarray, n):
    """bool[256]: which byte values occur in text_dev[:n] (device).

    Sort-based (one 1-op sort + 256 binary searches) — exact, no
    scatter and no 256-wide compare-sum (n x 256 work).
    Pad positions map to -1 and sort before every real value."""
    L = text_dev.shape[0]
    v = jnp.where(lax.iota(jnp.int32, L) < n,
                  text_dev.astype(jnp.int32), -1)
    s = lax.sort((v,), is_stable=False)[0]
    qs = jnp.arange(256, dtype=jnp.int32)
    lo = jnp.searchsorted(s, qs, side="left")
    hi = jnp.searchsorted(s, qs, side="right")
    return hi > lo


def remap_from_present(present: np.ndarray) -> tuple[np.ndarray, int, int]:
    """(remap, bits, h0) from a byte-presence mask — the tail of
    ``alphabet_remap`` without its host counting pass."""
    present = np.asarray(present, bool)
    remap = np.cumsum(present).astype(np.int32) * present
    k = max(int(remap.max()), 1)
    bits = max(1, int(k).bit_length())
    h0 = max(1, PACK_BITS // bits)
    return remap, bits, h0


def alphabet_remap_dev(text_dev, n: int) -> tuple[np.ndarray, int, int]:
    """``alphabet_remap`` computed from a device-resident text copy.

    The host counting pass is a full-text host read; the device
    sort-based presence kernel is exact and skips it. Callers that
    already hold the text on device
    (twin corpora, the standalone-LCP route) use this; the result is
    bit-identical to ``alphabet_remap(host_text)``."""
    present = np.asarray(jax.device_get(
        _presence_kernel(text_dev, jnp.int32(n))))
    return remap_from_present(present)


def pack_ranks_kernel(text_pad: jnp.ndarray, remap: jnp.ndarray,
                      bits: int, h0: int, n_real) -> jnp.ndarray:
    """Device-side packed initial ranks (order-preserving h0-prefix code).

    ``text_pad`` is uint8[n_pad] (zero pad bytes past ``n_real``); codes
    are looked up through ``remap`` and h0 of them are folded into each
    position's int32. ``bits``/``h0`` must be STATIC: the fold then
    unrolls into static-offset reads that XLA fuses with the ``remap``
    lookup into one pass over the text and one int32 write. Runs inside
    the build kernel so only raw bytes cross the host->device link.
    """
    n_pad = text_pad.shape[0]
    codes = remap[text_pad]
    iota = lax.iota(jnp.int32, n_pad)
    codes = jnp.where(iota < n_real, codes, 0)
    ext = jnp.concatenate([codes, jnp.zeros((PACK_BITS,), jnp.int32)])
    out = jnp.zeros((n_pad,), jnp.int32)
    for j in range(h0):
        out = (out << bits) | lax.slice(ext, (j,), (j + n_pad,))
    return out


@functools.partial(jax.jit, static_argnums=(2, 3))
def suffix_array_from_bytes_kernel(text_pad: jnp.ndarray, remap: jnp.ndarray,
                                   bits: int, h0: int, n_real: jnp.ndarray):
    """One-dispatch build: device-side packing + the doubling loop.

    bits/h0 are static (one cached compile per alphabet class; there are
    at most 8 distinct (bits, h0) pairs for byte alphabets).
    """
    rank0 = pack_ranks_kernel(text_pad, remap, bits, h0, n_real)
    return suffix_array_kernel(rank0, jnp.int32(h0))


def pack_initial_ranks(arr: np.ndarray, n_pad: int) -> tuple[np.ndarray, int]:
    """Host-side packed initial ranks (same code as pack_ranks_kernel).

    Kept as the host-side reference for the device packing (the sharded
    builder packs per-shard on device, parallel/doubling.py) and for
    tests/tools that want packed ranks without a device.
    """
    n = int(arr.shape[0])
    if n == 0:
        return np.zeros(n_pad, np.int32), 1
    remap, bits, h0 = alphabet_remap(arr)
    v = np.zeros(n_pad + h0 - 1, np.int32)
    v[:n] = remap[arr]
    out = np.zeros(n_pad, np.int32)
    for j in range(h0):
        out = (out << bits) | v[j:j + n_pad]
    return out, h0


def bucket_size(n: int, multiple_of: int = 1) -> int:
    """Round n up to a compile-cache-friendly bucket (1+1/8 granularity).

    Bounds the number of distinct jitted shapes to ~8 per octave while
    wasting at most 12.5% padding, and enforces divisibility by
    ``multiple_of`` (the mesh size for the sharded path).
    """
    n = max(n, 1)
    step = max(1 << max(int(n - 1).bit_length() - 3, 0), multiple_of)
    return -(-n // step) * step


def build_suffix_array(text, info: dict | None = None,
                       text_dev=None) -> jnp.ndarray:
    """Build the suffix array of ``text`` (bytes, str, or uint8 array).

    ``info``: optional dict build metadata is copied into — ``path``
    (which builder ran) and, for the carried-keys paths, the ``rerun``
    honesty key when a misprediction re-executed the build (the CLI
    surfaces it as RERUN in STRUCTURED_RESULTS).

    ``text_dev``: optional pre-staged device copy of the text (same
    bytes, zero-padded). Forwarded to whichever carried-keys builder
    runs when its padded geometry matches the array's shape —
    ``bucket_size(n)`` for the direct route, ``chunk_geometry(n)[2]``
    for the MSD — skipping the host->device stage inside the build
    (device-resident corpora; see utils/twin.py and the README
    benchmarking notes for why staging is pathological here). A
    mismatched shape is ignored (the build stages normally).

    The text is padded at the end with a sub-byte sentinel rank to a bucketed
    length: every pad suffix is a strict prefix-of-pads string that ranks
    below all real suffixes (any real byte maps to rank >= 1 > 0), so the
    padded suffix order is [pad positions ...][real suffix array] and the
    real SA is recovered by a static tail slice. This keeps shapes static
    and bucketed for XLA, replacing the reference's malloc-per-size
    (manber_myers.c:83-85).

    Routing (see core/bigsort.py, esp. ``prefer_direct``):
      * n > SA_BIG_THRESHOLD (default 4 MiB): the carried-keys paths —
        the direct one-sort build up to the crossover
        (`SA_DIRECT_CROSS`, 2^27) or for chain-class periodic texts up
        to the feasibility cap (`SA_DIRECT_MAX`, 2^28), else the
        two-sort fine-geometry MSD bucket machinery. Both gates come
        from an earlier accelerator and are to be re-derived on the GPU
        (ROADMAP item 3). The doubling kernel's ~30 B/char working set
        caps it at 256 MiB on a 16 GB device. Degenerate texts the
        carried-keys paths decline (residue overflow, bucket skew)
        fall back to the doubling kernel while it fits (<= 256 MiB);
      * n > SA_CHAIN_MIN (default 4 MiB) with long repeats detected by a
        host-side sample: the bucket sort's periodic-chain resolution,
        which replaces the doubling loop's log2(n) rounds on periodic
        text with one windowed sort pass (falls back here on
        non-globally-periodic repeat structure).
    """
    import os

    arr = as_byte_array(text)
    n = int(arr.shape[0])
    if n == 0:
        return jnp.zeros((0,), jnp.int32)
    big_threshold = int(os.environ.get("SA_BIG_THRESHOLD", 1 << 22))
    if n > big_threshold:
        from hpc_suffix_array_tpu.core.bigsort import (
            build_suffix_array_big, build_suffix_array_direct,
            chunk_geometry, estimate_repeat_len, prefer_direct)

        def dev_for(shape_len: int):
            return (text_dev if text_dev is not None
                    and tuple(text_dev.shape) == (shape_len,) else None)

        # One alphabet/repeat scan feeds the routing gate AND the chosen
        # builder's plan (each re-scan is a full-text host pass).
        remap, _, _ = alphabet_remap(arr)
        est = estimate_repeat_len(arr)
        try:
            if prefer_direct(arr, n, est_repeat=est,
                             sigma=int(remap.max())):
                try:                    # ONE sort when the triple fits
                    out = build_suffix_array_direct(
                        arr, info=info, text_dev=dev_for(bucket_size(n)),
                        remap=remap, est_repeat=est)
                    if info is not None:
                        info["path"] = "direct"
                    return out
                except NotImplementedError:
                    pass                # residue overflow: MSD's caps scale
            out = build_suffix_array_big(
                arr, info=info, text_dev=dev_for(chunk_geometry(n)[2]),
                remap=remap, est_repeat=est)
            if info is not None:
                info["path"] = "msd"
            return out
        except NotImplementedError:
            # No doubling fallback fits there: sized for a 16 GB
            # device; not re-derived for this card (ROADMAP D7).
            if n > 1 << 28:
                return sais_host_fallback(arr, info)
    elif n > int(os.environ.get("SA_CHAIN_MIN", 1 << 22)):
        from hpc_suffix_array_tpu.core.bigsort import (
            build_suffix_array_big, build_suffix_array_direct,
            estimate_repeat_len, prefer_direct)
        est = estimate_repeat_len(arr)
        from hpc_suffix_array_tpu.core.bigsort import deep_repeat_class
        if deep_repeat_class(est):              # beyond one-pass windows
            try:
                if prefer_direct(arr, n, est_repeat=est):
                    try:
                        out = build_suffix_array_direct(arr, info=info,
                                                        est_repeat=est)
                        if info is not None:
                            info["path"] = "direct"
                        return out
                    except NotImplementedError:
                        pass
                out = build_suffix_array_big(arr, info=info,
                                             est_repeat=est)
                if info is not None:
                    info["path"] = "msd"
                return out
            except NotImplementedError:
                pass                            # irregular repeats: doubling
    n_pad = bucket_size(n)
    host = np.zeros(n_pad, np.uint8)
    host[:n] = arr
    text_pad = jnp.asarray(host)
    remap, bits, h0 = alphabet_remap(arr)
    sa, _rank, _rounds = suffix_array_from_bytes_kernel(
        text_pad, jnp.asarray(remap), bits, h0, jnp.int32(n))
    if info is not None:
        info["path"] = "doubling"
    return sa[n_pad - n:]


def sais_host_fallback(arr: np.ndarray, info: dict | None = None):
    """Last-resort builder: host SA-IS (native C, O(n)) for texts every
    device path declined.

    With device refinement (core/refine.py) the carried-keys builders
    resolve any bounded-depth tie structure, so this fires only for
    adversarial corpora — e.g. a >256 MiB text dominated by one
    non-periodic multi-megabyte repeated block (deep AND wide ties
    beyond the refinement caps). The reference handles such inputs in
    its O(n log n) C core (src/sequential/manber_myers.c:81-133); this
    repo must never refuse a valid input either (r5), and SA-IS is
    O(n) — typically FASTER than the reference on these monsters. The
    result returns committed to the host CPU backend: the caller most
    likely consumes it on the host anyway.
    """
    from hpc_suffix_array_tpu import native

    if not native.available():
        raise NotImplementedError(
            "text declined by every device builder and the native "
            "SA-IS fallback is unavailable (no C compiler)")
    sa_np = native.sa_build(arr)
    if info is not None:
        info["path"] = "sais_host"
    try:
        return jax.device_put(sa_np, jax.devices("cpu")[0])
    except RuntimeError:
        return jnp.asarray(sa_np)


def as_byte_array(text) -> np.ndarray:
    """Coerce str/bytes/array input to a uint8 numpy array (zero-copy where possible)."""
    if isinstance(text, str):
        text = text.encode("utf-8")
    if isinstance(text, (bytes, bytearray, memoryview)):
        return np.frombuffer(bytes(text), dtype=np.uint8)
    arr = np.asarray(text)
    if arr.dtype != np.uint8:
        arr = arr.astype(np.uint8)
    return arr


@dataclass
class SuffixArray:
    """Result object bundling text, SA, and LCP.

    The lifecycle equivalent of the reference's ``SuffixArray`` struct plus
    create/destroy (src/common/suffix_array.h:16-21, manber_myers.c:51-78);
    in Python, construction *is* `create`, garbage collection is `destroy`.
    """

    text: np.ndarray            # uint8[n]
    sa: jnp.ndarray | None = None     # int32[n]
    lcp: jnp.ndarray | None = None    # int32[n]
    mesh: object | None = None        # jax.sharding.Mesh -> sharded kernels
    timings: dict = field(default_factory=dict)

    @classmethod
    def create(cls, text, mesh=None) -> "SuffixArray":
        return cls(text=as_byte_array(text), mesh=mesh)

    @property
    def n(self) -> int:
        return int(self.text.shape[0])

    def build(self) -> "SuffixArray":
        if self.mesh is not None:
            from hpc_suffix_array_tpu.parallel import (
                build_suffix_array_sharded)
            self.sa = build_suffix_array_sharded(self.text, self.mesh)
        else:
            self.sa = build_suffix_array(self.text)
        return self

    def build_lcp(self) -> "SuffixArray":
        if self.sa is None:
            self.build()
        if self.mesh is not None:
            from hpc_suffix_array_tpu.parallel import build_lcp_array_sharded
            self.lcp = build_lcp_array_sharded(self.text, self.sa, self.mesh)
        else:
            from hpc_suffix_array_tpu.core.lcp import build_lcp_array
            self.lcp = build_lcp_array(self.text, self.sa)
        return self

    def longest_repeated_substring(self):
        from hpc_suffix_array_tpu.core.lrs import find_longest_repeated_substring
        if self.lcp is None:
            self.build_lcp()
        return find_longest_repeated_substring(self.text, self.sa, self.lcp)

    def validate(self) -> bool:
        if self.sa is None:
            self.build()
        if self.mesh is not None:
            from hpc_suffix_array_tpu.parallel import (
                is_valid_suffix_array_sharded)
            return is_valid_suffix_array_sharded(self.text, self.sa, self.mesh)
        from hpc_suffix_array_tpu.core.validate import is_valid_suffix_array
        return is_valid_suffix_array(self.text, self.sa)
