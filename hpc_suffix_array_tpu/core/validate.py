"""Suffix-array self-validation, O(n) and fully vectorized.

The reference validates with a permutation check plus adjacent ``strcmp``
(src/sequential/manber_myers.c:184-202) - O(n^2) worst case, and it runs on
*every* CLI invocation (main_sequential.c:120). This module implements the
standard linear-time verification instead:

  sa is the suffix array of text iff
    (1) sa is a permutation of [0, n);
    (2) for consecutive entries a = sa[j-1], b = sa[j]:
        text[a] < text[b],  or
        text[a] == text[b] and next_rank(a) < next_rank(b),
  where next_rank(s) = isa[s+1] (rank of the following suffix) and the empty
  suffix ranks below everything (-1). Condition (2) with isa derived from sa
  itself inductively forces full lexicographic order.

All checks are vector comparisons + one scatter; no host loop, no strcmp.
The permutation check rides the isa scatter itself (init -1; every slot
written exactly once iff sa is a permutation, by pigeonhole) — no separate
count buffer. Above ``SA_VALIDATE_FUSED_MAX`` bytes (default 2^26) the
order check runs in fixed-width chunks instead of one fused program: the
fused form's gather temporaries did not fit a 16 GB device at 2^30
alongside live build buffers, while the chunked form holds only text +
sa + isa (~9 GiB at 2^30) plus one chunk of temporaries — this is what
lets the CLI keep the reference's validate-every-run contract at the
1 GiB ladder config. The threshold is sized for a 16 GB device; not
re-derived for this card (ROADMAP D7).
"""

from __future__ import annotations

import functools
import os

import jax
import jax.numpy as jnp
from jax import lax

from hpc_suffix_array_tpu.core.suffix_array import as_byte_array


@jax.jit
def _isa_kernel(sa):
    """(isa, is_permutation): inverse permutation with -1 holes."""
    n = sa.shape[0]
    iota = lax.iota(jnp.int32, n)
    in_range = jnp.all((sa >= 0) & (sa < n))
    sa_c = jnp.clip(sa, 0, n - 1)
    isa = jnp.full((n,), -1, jnp.int32).at[sa_c].set(iota)
    # n writes into n slots with no hole <=> bijection (pigeonhole).
    return isa, in_range & jnp.all(isa >= 0)


@jax.jit
def validate_kernel(text: jnp.ndarray, sa: jnp.ndarray):
    """One fused program: permutation + adjacent-order check."""
    n = text.shape[0]
    isa, is_perm = _isa_kernel(sa)
    sa_c = jnp.clip(sa, 0, n - 1)

    def next_rank(s):
        return jnp.where(s + 1 < n, isa[jnp.minimum(s + 1, n - 1)],
                         jnp.int32(-1))

    a, b = sa_c[:-1], sa_c[1:]
    ca, cb = text[a].astype(jnp.int32), text[b].astype(jnp.int32)
    ordered = jnp.all((ca < cb) | ((ca == cb) & (next_rank(a) < next_rank(b))))
    return is_perm & ordered


@jax.jit
def _in_range(sa):
    n = sa.shape[0]
    return jnp.all((sa >= 0) & (sa < n))


@functools.partial(jax.jit, static_argnums=(0,), donate_argnums=(1,))
def _isa_scatter_chunk(L: int, isa, sa_p, start, n):
    """Scatter one chunk of the inverse permutation into the donated
    accumulator (in-place via donation — the fused isa build's
    sa+iota+init+result working set did not fit a 16 GB device at 2^30
    with the text alive)."""
    seg = lax.dynamic_slice(sa_p, (start,), (L,))
    rows = start + lax.iota(jnp.int32, L)
    # Rows past n (padding) scatter to an out-of-range slot and drop.
    tgt = jnp.where(rows < n, jnp.clip(seg, 0, n - 1), n)
    return isa.at[tgt].set(rows, mode="drop")


@functools.partial(jax.jit, static_argnums=(0,))
def _order_chunk(L: int, text, isa, sa, start, n):
    """Order check for SA rows (j-1, j), j in [start+1, start+L]."""
    seg = lax.dynamic_slice(sa, (start,), (L + 1,))   # clamped at the end
    j = start + 1 + lax.iota(jnp.int32, L)
    real = j < n
    a = jnp.clip(seg[:-1], 0, n - 1)
    b = jnp.clip(seg[1:], 0, n - 1)
    ca = text[a].astype(jnp.int32)
    cb = text[b].astype(jnp.int32)
    na = jnp.where(a + 1 < n, isa[jnp.minimum(a + 1, n - 1)], jnp.int32(-1))
    nb = jnp.where(b + 1 < n, isa[jnp.minimum(b + 1, n - 1)], jnp.int32(-1))
    good = (ca < cb) | ((ca == cb) & (na < nb))
    return jnp.all(good | ~real)


def is_valid_suffix_array(text, sa) -> bool:
    """True iff ``sa`` is exactly the suffix array of ``text``."""
    arr = jnp.asarray(as_byte_array(text), jnp.uint8)
    n = int(arr.shape[0])
    if n == 0:
        return True
    sa_d = jnp.asarray(sa, jnp.int32)
    if int(sa_d.shape[0]) != n:
        return False
    fused_max = int(os.environ.get("SA_VALIDATE_FUSED_MAX", 1 << 26))
    if n <= fused_max:
        return bool(validate_kernel(arr, sa_d))
    L = min(1 << 24, fused_max)
    n_chunks = -(-(n - 1) // L)
    # Pad so every fixed L+1 window fits: lax.dynamic_slice CLAMPS an
    # overrunning START (misaligning the window with its j rows); padded
    # rows are masked out inside the chunks.
    pad = n_chunks * L + 1 - n
    sa_p = jnp.concatenate([sa_d, jnp.zeros((pad,), jnp.int32)]) \
        if pad > 0 else sa_d
    # Chunked isa build: peak device memory = text + sa + isa (+ one
    # chunk of temporaries) ~ 9.7 GiB at 2^30 — validates with the
    # build's own buffers still alive.
    isa = jnp.full((n,), -1, jnp.int32)
    for c in range(-(-n // L)):
        isa = _isa_scatter_chunk(L, isa, sa_p, jnp.int32(c * L),
                                 jnp.int32(n))
    if not bool(jax.device_get(_in_range(sa_d) & jnp.all(isa >= 0))):
        return False
    # Enqueue every order chunk, fetch ONCE (one host round-trip per
    # chunk otherwise, 64 of them at 2^30).
    flags = [_order_chunk(L, arr, isa, sa_p, jnp.int32(c * L),
                          jnp.int32(n))
             for c in range(n_chunks)]
    return bool(jax.device_get(jnp.all(jnp.stack(flags))))
