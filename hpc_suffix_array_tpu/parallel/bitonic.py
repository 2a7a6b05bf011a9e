"""Distributed block-bitonic sort (compare-split over a device hypercube).

The sharded replacement for the reference's per-round "gather everything
to rank 0 and qsort it there" (src/mpi/manber_myers_mpi.c:111-118). Here no
device ever holds more than 2·(n/P) records: each compare-exchange of the
classical bitonic sorting network on P elements is replaced by a
*compare-split* on P sorted blocks (merge the two blocks, lower-id side of
an ascending comparator keeps the smaller half). By the replacement
principle for sorting networks, the result is globally sorted across the
mesh axis, each block sorted ascending.

Why bitonic and not sample sort: the network is *oblivious* — the
communication pattern is static (log²P `ppermute` steps), every shard stays
exactly n/P elements, and it is completely immune to key skew (the
reference's corpora include degenerate all-'a' and periodic texts,
scripts/generate_large_datasets.py:16-23,94, which would break
splitter-based partitioning). Static patterns also mean the whole doubling
loop stays inside a single `lax.while_loop` with zero retracing.

Communication per full sort: log2(P)·(log2(P)+1)/2 full-shard exchanges
riding NVLink neighbor links — vs the reference's per-round Gatherv(n) +
Bcast(n) through one root NIC.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _compare_split(arrs, num_keys: int, axis_name: str, j: int, k: int,
                   me: jnp.ndarray, n_shards: int):
    """One compare-split step: exchange with partner ``me ^ j``, keep a half.

    ``arrs`` is a tuple of int32[m] locally-sorted columns; the first
    ``num_keys`` are lexicographic sort keys. Comparator direction follows
    the standard bitonic network: ascending iff (me & k) == 0; the lower
    partner of an ascending comparator keeps the min half.
    """
    m = arrs[0].shape[0]
    perm = [(i, i ^ j) for i in range(n_shards)]
    packed = jnp.stack(arrs)                      # (c, m) — one ppermute
    other = lax.ppermute(packed, axis_name, perm)
    ascending = (me & k) == 0
    i_am_low = (me & j) == 0
    # Canonical merge order (low shard's block first) + stable sort: both
    # partners then compute bit-identical merged arrays even when keys tie,
    # so the kept halves partition the union exactly. Without this, ties
    # let the two unstable sorts disagree and records get duplicated/lost.
    lo = jnp.where(i_am_low, packed, other)
    hi = jnp.where(i_am_low, other, packed)
    cat = jnp.concatenate([lo, hi], axis=1)       # (c, 2m)
    merged = lax.sort(tuple(cat[i] for i in range(len(arrs))),
                      num_keys=num_keys, is_stable=True)
    keep_min = ascending == i_am_low
    return tuple(jnp.where(keep_min, x[:m], x[m:]) for x in merged)


def block_bitonic_sort(arrs, num_keys: int, axis_name: str, n_shards: int):
    """Globally sort block-sharded columns across ``axis_name``.

    Args:
      arrs: tuple of int32[m] local shards (same m on every device).
      num_keys: leading entries of ``arrs`` used as lexicographic keys.
      axis_name: mesh axis name (must have power-of-two size ``n_shards``).

    Returns the same tuple shape, globally sorted: concatenating the
    shards in device order yields the fully sorted columns.
    """
    # Local pre-sort may be unstable: only the block's sorted MULTISET
    # feeds the compare-splits (whose internal merge stays stable for
    # cross-partner exactness, see _compare_split).
    arrs = lax.sort(tuple(arrs), num_keys=num_keys, is_stable=False)
    if n_shards == 1:
        return arrs
    me = lax.axis_index(axis_name)
    k = 2
    while k <= n_shards:
        j = k // 2
        while j >= 1:
            arrs = _compare_split(arrs, num_keys, axis_name, j, k, me,
                                  n_shards)
            j //= 2
        k *= 2
    return arrs
