"""Distributed random-access gather: out[i] = values[indices[i]], sharded.

The reference sidesteps distributed random access entirely by replicating
whole arrays on every rank (src/mpi/main_mpi.c:43-51,
src/mpi/manber_myers_mpi.c:136). Here neither values nor indices are
replicated: value blocks rotate around the mesh ring (P-1 statically
patterned `ppermute` steps, riding neighbor NVLink links) and every shard
serves its local requests as each block visits — no shard ever holds more
than 2 blocks, and the pattern is static so the primitive composes with
`lax.while_loop` / nested use inside shard_map.

Cost: P neighbor exchanges of one block + P local gathers of m elements
= O(n) gather work per device-row sweep. Right-sized for the small meshes
of one host (P <= 8). Beyond that, ``dist_gather_routed`` routes each
request directly to its owner: sort requests by owner locally, exchange
fixed-budget request blocks with ONE all_to_all, serve each request with
a single local gather, and route the answers back with a second
all_to_all — O(r log r) local work + 2 all_to_all hops instead of P ring
sweeps. The fixed per-owner budget makes the exchange shape static; a
skew overflow (one owner attracting > budget requests, e.g. phi chains
on periodic text) is detected on device and the whole gather falls back
to the oblivious ring via lax.cond, so correctness never depends on the
request distribution. ``dist_gather`` dispatches between the two by mesh
size (ROUTED_MIN_SHARDS, default 16 — the ring's O(P·r) local-gather
work overtakes the routed path's two sorts around there).

Used by the sharded LCP builder (parallel/lcp.py) for phi-chain, plcp and
text gathers.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
from jax import lax

# Mesh size at which dist_gather switches from the ring to sorted
# request routing (override: SA_ROUTED_MIN_SHARDS).
ROUTED_MIN_SHARDS = int(os.environ.get("SA_ROUTED_MIN_SHARDS", 16))


def dist_gather(values: jnp.ndarray, indices: jnp.ndarray, axis_name: str,
                n_shards: int, fill=0) -> jnp.ndarray:
    """Gather across a block-sharded axis.

    Args:
      values:  [m, ...] local shard of the global value array (n = P*m rows).
      indices: int32[r] local shard of global row indices; out-of-range
               (< 0 or >= n) yields ``fill``.
      fill:    value returned for out-of-range indices.

    Returns values[indices] (local shard, requester order).
    """
    m = values.shape[0]
    n = n_shards * m
    safe = jnp.clip(indices, 0, n - 1)
    if n_shards >= ROUTED_MIN_SHARDS:
        out = _serve_routed(values, safe, axis_name, n_shards)
    else:
        out = _serve_ring(values, safe, axis_name, n_shards)
    ok = (indices >= 0) & (indices < n)
    if values.ndim > 1:
        ok = ok.reshape(ok.shape + (1,) * (values.ndim - 1))
    return jnp.where(ok, out, jnp.asarray(fill, values.dtype))


def _serve_ring(values: jnp.ndarray, src: jnp.ndarray, axis_name: str,
                n_shards: int) -> jnp.ndarray:
    """values[src] for in-range src, rotating value blocks around the ring."""
    m = values.shape[0]
    me = lax.axis_index(axis_name)
    out = jnp.zeros(src.shape + values.shape[1:], values.dtype)
    block = values
    owner = me                       # owner id of the currently held block
    perm = [(i, (i - 1) % n_shards) for i in range(n_shards)]
    for step in range(n_shards):
        lo = owner * m
        local = jnp.clip(src - lo, 0, m - 1)
        hit = (src >= lo) & (src < lo + m)
        if values.ndim > 1:
            hit = hit.reshape(hit.shape + (1,) * (values.ndim - 1))
        out = jnp.where(hit, block[local], out)
        if step + 1 < n_shards:
            block = lax.ppermute(block, axis_name, perm)
            owner = (owner + 1) % n_shards
    return out


def _serve_routed(values: jnp.ndarray, src: jnp.ndarray, axis_name: str,
                  n_shards: int, slack: int = 2) -> jnp.ndarray:
    """values[src] via sorted request routing: 2 all_to_all hops, serve once.

    Each shard sorts its requests by owner shard, packs them into a
    static (P, budget) matrix (budget = ``slack`` * ceil(r/P)), exchanges
    rows with one all_to_all, serves the incoming requests with a single
    local gather, and routes the answers back with a second all_to_all.
    Local work is O(r log r) + one gather of P*budget elements —
    independent of P except for the exchange itself, vs the ring's P
    local sweeps.

    The static budget cannot absorb arbitrary skew: if any owner attracts
    more than ``budget`` of one shard's requests (periodic-text phi
    chains do this), every shard agrees on the overflow via pmax and the
    whole call takes the oblivious-ring branch of the lax.cond instead —
    the predicate is axis-uniform, so the collectives inside both
    branches stay deadlock-free.
    """
    m = values.shape[0]
    r = src.shape[0]
    P = n_shards
    c = min(r, slack * (-(-r // P)))
    owner = (src // m).astype(jnp.int32)
    pos = lax.iota(jnp.int32, r)
    o_s, src_s, pos_s = lax.sort((owner, src, pos), num_keys=1)
    # slot of each sorted request within its owner's group
    first = jnp.searchsorted(o_s, o_s, side="left").astype(jnp.int32)
    slot = lax.iota(jnp.int32, r) - first
    overflow = lax.pmax((slot >= c).any().astype(jnp.int32), axis_name) > 0

    def _routed(_):
        reqmat = jnp.full((P, c), -1, jnp.int32)
        reqmat = reqmat.at[o_s, slot].set(src_s, mode="drop")
        recv = lax.all_to_all(reqmat, axis_name, 0, 0, tiled=True)
        lo = lax.axis_index(axis_name) * m
        ans = values[jnp.clip(recv - lo, 0, m - 1)]      # (P, c, ...)
        back = lax.all_to_all(ans, axis_name, 0, 0, tiled=True)
        out_s = back[o_s, slot]                          # sorted order
        out = jnp.zeros(src.shape + values.shape[1:], values.dtype)
        return out.at[pos_s].set(out_s)

    return lax.cond(overflow,
                    lambda _: _serve_ring(values, src, axis_name, n_shards),
                    _routed, operand=None)


def dist_scatter_perm(values: jnp.ndarray, dest: jnp.ndarray,
                      axis_name: str, n_shards: int) -> jnp.ndarray:
    """out[dest[i]] = values[i] where ``dest`` is a global permutation.

    The inverse routing of ``dist_gather``: each shard's (dest, value)
    pairs rotate around the ring; the shard owning ``dest`` claims the
    element. Requires dest to be a permutation of [0, n) globally (true
    for rank scatters in the doubling loop: dest = suffix index).
    """
    m = values.shape[0]
    me = lax.axis_index(axis_name)
    lo = me * m
    out = jnp.zeros((m + 1,), values.dtype)   # slot m swallows non-hits
    pair = jnp.stack([dest, values])
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    for step in range(n_shards):
        d, v = pair[0], pair[1]
        hit = (d >= lo) & (d < lo + m)
        # dest is a permutation, so hits never collide; non-hits land in
        # the dummy slot instead of clobbering real entries.
        out = out.at[jnp.where(hit, d - lo, m)].set(v)
        if step + 1 < n_shards:
            pair = lax.ppermute(pair, axis_name, perm)
    return out[:m]
