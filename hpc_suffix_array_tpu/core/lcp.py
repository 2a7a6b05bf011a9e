"""LCP-array construction, on device.

The reference uses Kasai's O(n) h-decrement algorithm
(src/sequential/manber_myers.c:135-157), which is inherently sequential: each
position's h carries into the next. That is a poor fit for a 8x128-lane
vector machine, so this module computes the *PLCP* array (LCP indexed by text
position) with a data-parallel iterative algorithm, then permutes it into SA
order (lcp[j] = plcp[sa[j]], lcp[0] = 0 - same contract as the reference).

The parallel PLCP algorithm combines three O(n) vectorized steps per round,
each round one fused jitted program:

  1. **Verified extension**: every unresolved position compares the next
     ``CMP_WIDTH`` bytes of (suffix i, suffix phi[i]) at its current verified
     offset with one vector gather; the match count extends its lower bound,
     and any mismatch (or text end) resolves it exactly.
  2. **Monotone propagation**: by the classic PLCP lemma
     plcp[i] >= plcp[i-1] - 1, so plcp[i] + i is non-decreasing; a cumulative
     max scan (``lax.associative_scan``) turns every strong bound into strong
     bounds for all later positions - this resolves long runs with constant
     plcp+i (e.g. the repetitive corpora of the reference's dataset
     generator, scripts/generate_large_datasets.py:16-23) in O(1) rounds.
  3. **Pointer jumping**: if phi[i + cur] == phi[i] + cur (the partner chain
     is aligned, true throughout periodic text), then
     plcp[i] = cur + plcp[i + cur], so bounds compose: cur[i] += cur[i+cur].
     This doubles verified prefixes geometrically, giving O(log n) rounds on
     period-p strings such as the 'aaaa' (1000 x 'a') and 'ababab' fixtures
     (generate_large_datasets.py:94-95).

Every value is a *verified lower bound* at all times, so all three steps are
sound in any order; termination is guaranteed because each round either
resolves a position or extends it by >= 1.

The round loop is **host-driven** (one jitted round per dispatch, an
all-resolved scalar synced per round) rather than a `lax.while_loop`:
measured on 2 MB DNA, the while_loop variant cost 244 s of XLA:CPU compile
for 0.6 s of runtime, while the identical per-round program compiles in
~4 s; typical corpora converge in 1-5 rounds so the per-round host sync is
noise. Everything inside a round stays fused and device-resident.

Correctness oracle: Kasai in the native C helper
(hpc_suffix_array_tpu.native) and a NumPy reference (core.oracle).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from hpc_suffix_array_tpu.core.suffix_array import as_byte_array

# Bytes compared per unresolved position per round.
CMP_WIDTH = 32
# Positions per lax.map chunk: bounds the gather buffer to CHUNK*CMP_WIDTH.
CHUNK = 1 << 18
# Pointer-jumping steps per round (each approximately doubles verified runs).
JUMP_STEPS = 2


def _extend_chunk(text, n, args):
    """Compare CMP_WIDTH bytes for one chunk of positions; return match counts."""
    cur_c, phi_c, act_c, base_c = args
    offs = lax.iota(jnp.int32, CMP_WIDTH)[None, :]
    a_pos = base_c[:, None] + cur_c[:, None] + offs
    b_pos = phi_c[:, None] + cur_c[:, None] + offs
    a_ok = a_pos < n
    b_ok = (b_pos < n) & (b_pos >= 0)
    ta = text[jnp.clip(a_pos, 0, n - 1)]
    tb = text[jnp.clip(b_pos, 0, n - 1)]
    eq = (ta == tb) & a_ok & b_ok & act_c[:, None]
    return jnp.sum(jnp.cumprod(eq.astype(jnp.int32), axis=1), axis=1)


@jax.jit
def _plcp_setup(text: jnp.ndarray, sa: jnp.ndarray):
    """phi[i] = SA-predecessor of suffix i (-1 for the SA head) and the
    per-position upper bound limit[i] = n - max(i, phi[i])."""
    n = text.shape[0]
    iota = lax.iota(jnp.int32, n)
    isa = jnp.zeros((n,), jnp.int32).at[sa].set(iota)
    phi = jnp.where(isa > 0, sa[jnp.maximum(isa - 1, 0)], jnp.int32(-1))
    limit = jnp.where(phi >= 0, n - jnp.maximum(iota, phi), jnp.int32(0))
    return phi, limit


@functools.partial(jax.jit, donate_argnums=(4, 5))
def _plcp_round(text, phi_p, limit_p, iota_p, cur, resolved):
    """One fused propagate + jump + extend round (see module docstring)."""
    n = text.shape[0]
    n_pad = cur.shape[0]
    nc = n_pad // min(n_pad, CHUNK)
    chunk = n_pad // nc

    # 1) monotone propagation (plcp[i]+i non-decreasing).
    runmax = lax.associative_scan(jnp.maximum, cur + iota_p)
    prop = jnp.clip(jnp.maximum(cur, runmax - iota_p), 0, limit_p)
    cur = jnp.where(resolved, cur, prop)
    resolved = resolved | (cur >= limit_p)

    # 2) pointer jumping along the aligned phi chain.
    for _ in range(JUMP_STEPS):
        tgt = jnp.minimum(iota_p + cur, n_pad - 1)
        aligned = (~resolved) & (iota_p + cur < n) & (phi_p[tgt] == phi_p + cur)
        bumped = jnp.minimum(cur + cur[tgt], limit_p)
        now_exact = aligned & resolved[tgt]
        cur = jnp.where(aligned, bumped, cur)
        resolved = resolved | now_exact | ((~resolved) & (cur >= limit_p))

    # 3) verified extension by direct byte comparison, chunked.
    active = ~resolved
    m = lax.map(
        functools.partial(_extend_chunk, text, n),
        (cur.reshape(nc, chunk), phi_p.reshape(nc, chunk),
         active.reshape(nc, chunk), iota_p.reshape(nc, chunk)),
    ).reshape(n_pad)
    cur = cur + jnp.where(active, m, 0)
    resolved = resolved | (active & (m < CMP_WIDTH))
    return cur, resolved, jnp.all(resolved)


def plcp_kernel(text: jnp.ndarray, sa: jnp.ndarray):
    """Compute plcp int32[n]: plcp[i] = LCP(suffix i, its SA predecessor)."""
    n = int(text.shape[0])
    phi, limit = _plcp_setup(text, sa)

    # Pad to a chunk multiple so the extension step maps over fixed tiles
    # (chunk shrinks for small inputs to avoid pure-padding work).
    chunk = min(CHUNK, 1 << max(int(n - 1).bit_length(), 5))
    n_pad = -(-n // chunk) * chunk
    pad = n_pad - n

    def pad1(x, value):
        return jnp.concatenate([x, jnp.full((pad,), value, x.dtype)]) if pad else x

    cur = jnp.zeros((n_pad,), jnp.int32)
    resolved = pad1(phi < 0, True)
    phi_p = pad1(phi, -1)
    limit_p = pad1(limit, 0)
    iota_p = lax.iota(jnp.int32, n_pad)

    # Host-driven convergence: bounded by n/CMP_WIDTH, typically 1-5 rounds.
    for _ in range(n // CMP_WIDTH + 2):
        cur, resolved, done = _plcp_round(
            text, phi_p, limit_p, iota_p, cur, resolved)
        if bool(done):
            break
    return cur[:n]


@jax.jit
def lcp_from_plcp(plcp: jnp.ndarray, sa: jnp.ndarray):
    """Permute plcp into SA order; lcp[0] = 0 (reference manber_myers.c:145)."""
    n = sa.shape[0]
    lcp = plcp[sa]
    return lcp.at[0].set(0) if n else lcp


def _sa_lcp_big(text, n: int, text_dev=None, info=None):
    """(sa, lcp) via the carried-keys machinery, or None when the text is
    too degenerate for it (the window paths handle those).

    ``text_dev``: optional pre-staged device copy of the text (same
    bytes, zero-padded); forwarded to whichever builder's padded
    geometry it matches, skipping the host->device stage (bench/twin
    corpora).

    ``info``: optional dict the chosen builder's meta lands in (rerun
    honesty keys, chain_mode, n_patched — see build_suffix_array_big);
    this router adds ``info["path"]``."""
    from hpc_suffix_array_tpu.core.bigsort import (
        build_suffix_array_big, build_suffix_array_direct, chunk_geometry,
        estimate_repeat_len, prefer_direct)
    from hpc_suffix_array_tpu.core.suffix_array import (
        alphabet_remap, bucket_size)

    host = np.asarray(as_byte_array(text))   # host copy for planning
    # Planning products computed ONCE and threaded through the gate and
    # the chosen builder — each is a full-text host pass, and this
    # router otherwise triggers three of them. With a device text copy
    # the alphabet scan moves on-device entirely.
    if (text_dev is not None and int(text_dev.shape[0]) >= n
            and text_dev.dtype == jnp.uint8):
        from hpc_suffix_array_tpu.core.suffix_array import (
            alphabet_remap_dev)
        remap, _, _ = alphabet_remap_dev(text_dev, n)
    else:
        remap, _, _ = alphabet_remap(host)
    est = estimate_repeat_len(host)
    if prefer_direct(host, n, est_repeat=est, sigma=int(remap.max())):
        dev = (text_dev if text_dev is not None
               and tuple(text_dev.shape) == (bucket_size(n),) else None)
        try:
            out = build_suffix_array_direct(host, want_lcp=True,
                                            text_dev=dev, remap=remap,
                                            est_repeat=est, info=info)
            if info is not None:
                info["path"] = "direct"
            return out
        except NotImplementedError:
            pass
    dev = (text_dev if text_dev is not None
           and tuple(text_dev.shape) == (chunk_geometry(n)[2],) else None)
    try:
        out = build_suffix_array_big(host, want_lcp=True, text_dev=dev,
                                     remap=remap, est_repeat=est,
                                     info=info)
        if info is not None:
            info["path"] = "msd"
        return out
    except NotImplementedError:
        if n > 1 << 28:
            # Past the doubling/window fallbacks' reach: host SA-IS +
            # Kasai (both native C, O(n)) close the long tail so no
            # valid input is refused (see sais_host_fallback).
            from hpc_suffix_array_tpu import native
            from hpc_suffix_array_tpu.core.suffix_array import (
                sais_host_fallback)

            if native.available():
                sa_cpu = sais_host_fallback(host, info)
                lcp_np = native.lcp_kasai(host, np.asarray(sa_cpu))
                try:
                    import jax as _jax
                    lcp_cpu = _jax.device_put(
                        lcp_np, _jax.devices("cpu")[0])
                except RuntimeError:
                    lcp_cpu = jnp.asarray(lcp_np)
                return sa_cpu, lcp_cpu
        return None


def build_sa_lcp(text, *, info=None,
                 text_dev=None) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fused (suffix array, LCP array) build — the contract the reference
    CLI always serves (SA_TIME + LCP_TIME per run, main_sequential.c:41-49).

    Above SA_LCP_BIG_MIN this is ONE carried-keys pass (the LCP falls out
    of the sort keys, core/bigsort.py ``want_lcp``) — the production route
    for benchmark-scale texts, where a separate SA-then-LCP pair of calls
    would re-derive the suffix order twice. Below it, the standard
    builders run back to back.

    ``info``: optional dict for build metadata (path, rerun honesty
    keys — see build_suffix_array).

    ``text_dev``: optional pre-staged uint8 device copy of the text
    (see build_lcp_array; forwarded to every route).
    """
    import os

    arr = as_byte_array(text)
    n = int(arr.shape[0])
    if n > int(os.environ.get("SA_LCP_BIG_MIN", 1 << 23)):
        derived = _sa_lcp_big(arr, n, text_dev=text_dev, info=info)
        if derived is not None:
            return derived
    from hpc_suffix_array_tpu.core.suffix_array import build_suffix_array

    sa = build_suffix_array(arr, info=info, text_dev=text_dev)
    return sa, build_lcp_array(arr, sa, text_dev=text_dev)


def build_lcp_array(text, sa, *, text_dev=None) -> jnp.ndarray:
    """LCP array: lcp[j] = LCP(suffix sa[j-1], suffix sa[j]); lcp[0] = 0.

    Texts beyond SA_LCP_WINDOW_MIN bytes (default 4 MiB) use the chunked
    window-compare path (core/lcp_window.py) — its programs are in the
    sort/gather class, where the PLCP round program (scans +
    pointer-jumping gathers) compiled for hours at benchmark shapes on
    an earlier accelerator's remote compiler (host workaround, to be
    re-justified on the GPU host, ROADMAP D2). BELOW those thresholds,
    texts whose repeat estimate is deep (SA_LCP_CHAIN_EST, default 512
    bytes — the reference's repetitive corpus family,
    generate_large_datasets.py:16-23) also take the carried-keys rebuild
    from SA_LCP_CHAIN_MIN (16 KiB) up: the PLCP loop pays
    ~log2(repeat/CMP_WIDTH) scan-class rounds on them, while chain mode
    finishes them in one sort-class pass.

    Beyond SA_LCP_BIG_MIN bytes (default 8 MiB) the LCP comes from the
    carried-keys machinery instead (core/bigsort.py ``want_lcp`` —
    adjacent xor+clz on the carried sort keys; the direct one-sort
    build while preferred, else the fine-geometry MSD — prefer_direct):
    even though that path re-derives the suffix order from the text,
    the full SA+LCP rebuild outran or matched the standalone
    sorted-fetch pass at every size it serves on an earlier
    accelerator (not re-measured on the GPU), and beyond 256 MiB the
    sorted-fetch permutation sorts stop fitting a 16 GB device, where
    the rebuild still runs. Because that route
    re-derives the order, the supplied ``sa`` is cross-checked against
    the derived one (a single fused equality-reduce on device — the
    array was already staged) and a mismatch raises ValueError: a
    caller passing a wrong-but-valid permutation gets an error, never
    a silently ignored argument. The reference's Kasai contract equally
    assumes a correct SA (src/sequential/manber_myers.c:135) but walks
    it blindly; see also ``build_sa_lcp`` for the fused build that
    needs no precomputed SA.

    ``text_dev``: optional pre-staged uint8 device copy of the text
    (first n bytes equal to ``text``; may be longer/padded). The big
    route forwards it to whichever builder's padded geometry it
    matches (see _sa_lcp_big); the window and PLCP routes slice its
    first n bytes instead of staging the text again. Anything not
    matching the contract (shorter than n, or non-uint8) is ignored.
    """
    import os

    host = as_byte_array(text)
    n = int(host.shape[0])
    if n == 0:
        return jnp.zeros((0,), jnp.int32)
    sa = jnp.asarray(sa, jnp.int32)
    if sa.shape[0] != n:
        raise ValueError(f"sa length {sa.shape[0]} != text length {n}")

    def arr_dev():
        # Device text, staged only by the routes that read it (the big
        # route plans on the host + its own text_dev, so staging the
        # whole text up front would be wasted there).
        # A caller-supplied text_dev shares its first n bytes by
        # contract, so a slice serves instead of a transfer. Anything
        # that is not a uint8 array of at least n bytes is NOT that
        # contract — ignore it and stage, rather than feed a wider
        # dtype into the packing kernels.
        if (text_dev is not None and int(text_dev.shape[0]) >= n
                and text_dev.dtype == jnp.uint8):
            return text_dev[:n]
        return jnp.asarray(host, jnp.uint8)

    if n > int(os.environ.get("SA_LCP_BIG_MIN", 1 << 23)):
        derived = _sa_lcp_big(host, n, text_dev=text_dev)
        if derived is not None:
            _sa, lcp = derived
            if not _same_sa(_sa, sa):
                raise ValueError(
                    "supplied sa is not the suffix array of text: the "
                    "large-text LCP route derives the order from the text "
                    "(carried-keys build) and honors `sa` by cross-checking "
                    "it, so a different permutation cannot be served "
                    "silently; pass the true SA or call build_sa_lcp(text)")
            return lcp
    if n > int(os.environ.get("SA_LCP_WINDOW_MIN", 1 << 22)):
        try:
            if os.environ.get("SA_LCP_FETCH", "sorted") == "window":
                from hpc_suffix_array_tpu.core.lcp_window import (
                    build_lcp_array_window)
                return build_lcp_array_window(arr_dev(), sa)
            from hpc_suffix_array_tpu.core.lcp_window import (
                build_lcp_array_sorted)
            return build_lcp_array_sorted(arr_dev(), sa)
        except NotImplementedError:
            # Degenerate tie structure (deep non-periodic repeats) that
            # both the carried-keys and window finishers refuse: the
            # PLCP rounds below handle ANY text; the cap on them is a
            # host workaround for an earlier remote compiler, to be
            # re-justified on the GPU host (ROADMAP D2) — fall back only
            # under the cap, re-raise the window path's actionable
            # message above it.
            if n > int(os.environ.get("SA_LCP_PLCP_MAX", 1 << 23)):
                raise
    elif (n >= int(os.environ.get("SA_LCP_CHAIN_MIN", 1 << 14))
          and _deep_repeat(np.asarray(host), n)):
        # Mid-size texts with DEEP repeats (the reference's repetitive
        # family below the window/big thresholds): the PLCP loop pays
        # ~log2(repeat/CMP_WIDTH) host-driven rounds of scan-class
        # programs — 9 rounds / 2.36 s at 1 MB p1000 on CPU — while the
        # carried-keys rebuild is one sort-class pass (0.42 s warm, same
        # machine; chain mode covers periodic text at any n). Cross-check the supplied sa exactly
        # like the big route; refusals fall through to the PLCP rounds,
        # which remain the any-skew closer at these sizes.
        derived = _sa_lcp_big(host, n, text_dev=text_dev)
        if derived is not None:
            _sa, lcp = derived
            if not _same_sa(_sa, sa):
                raise ValueError(
                    "supplied sa is not the suffix array of text: the "
                    "repetitive-text LCP route derives the order from the "
                    "text (carried-keys build) and cross-checks `sa`; pass "
                    "the true SA or call build_sa_lcp(text)")
            return lcp
    plcp = plcp_kernel(arr_dev(), sa)
    return lcp_from_plcp(plcp, sa)


def _same_sa(derived, supplied) -> bool:
    """Equality of the derived and supplied SA, tolerant of the two
    living on different backends (the SA-IS fallback returns
    CPU-committed arrays; cross-device jnp comparison raises)."""
    try:
        return bool(jax.device_get(jnp.all(derived == jnp.asarray(
            supplied, jnp.int32))))
    except Exception:
        return bool(np.array_equal(np.asarray(derived),
                                   np.asarray(supplied)))


def _deep_repeat(arr: np.ndarray, n: int) -> bool:
    """Longest-repeat estimate exceeds what the PLCP rounds absorb
    cheaply (each round extends ~CMP_WIDTH bytes + doubles via pointer
    jumps; repeats past SA_LCP_CHAIN_EST mean multiple extra rounds)."""
    import os

    from hpc_suffix_array_tpu.core.bigsort import estimate_repeat_len

    return (estimate_repeat_len(arr)
            > int(os.environ.get("SA_LCP_CHAIN_EST", 512)))
