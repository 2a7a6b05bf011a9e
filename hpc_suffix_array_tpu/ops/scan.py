"""Re-rank scan: dense rank assignment over the sorted pair sequence.

Replaces the reference's sequential re-rank loop
(src/sequential/manber_myers.c:101-110) with a vectorized
adjacent-difference + cumulative-sum scan, then a permutation back to
suffix order. The permutation is one scatter: on the H100 it beat the
1-key-sort route inside the doubling kernel on every multi-round corpus
measured (PERF.md, PR 1), and it was already the cheaper form on the CPU.
"""

from __future__ import annotations

import jax.numpy as jnp


def dense_ranks(sorted_rank: jnp.ndarray, sorted_rank_k: jnp.ndarray):
    """Dense rank per sorted record (cumsum of adjacent-difference flags).

    Returns (dense int32[n], max_rank scalar). ``max_rank == n-1`` means
    all ranks are distinct (early-termination condition, reference
    manber_myers.c:113).
    """
    prev_r = jnp.concatenate([sorted_rank[:1], sorted_rank[:-1]])
    prev_rk = jnp.concatenate([sorted_rank_k[:1], sorted_rank_k[:-1]])
    bumps = (sorted_rank != prev_r) | (sorted_rank_k != prev_rk)
    bumps = bumps.at[0].set(False)
    dense = jnp.cumsum(bumps.astype(jnp.int32))
    return dense, dense[-1]


def route_to_positions(sorted_idx: jnp.ndarray, dense: jnp.ndarray):
    """Permute dense ranks from sorted order back to suffix-position order:
    ``out[sorted_idx[j]] = dense[j]`` (``sorted_idx`` is a permutation)."""
    n = sorted_idx.shape[0]
    return jnp.zeros((n,), jnp.int32).at[sorted_idx].set(dense)


def rerank_sorted(sorted_rank: jnp.ndarray, sorted_rank_k: jnp.ndarray,
                  sorted_idx: jnp.ndarray):
    """Dense re-rank + permutation to suffix order (see the two stages)."""
    dense, max_rank = dense_ranks(sorted_rank, sorted_rank_k)
    return route_to_positions(sorted_idx, dense), max_rank
