"""Fully-sharded LCP construction (distributed PLCP).

The reference keeps LCP strictly sequential on the MPI root by design
(src/mpi/main_mpi.c:66-69 — its "Amdahl split"); this module removes that
serial tail: the same three-step PLCP algorithm as core/lcp.py (verified
extension, monotone-bound propagation, pointer jumping — see that module's
docstring for the algorithm and its invariants) runs with every array
block-sharded over the mesh:

  * setup: isa via ring scatter of a global permutation, phi via ring
    gather (parallel/gather.py) — no replicated arrays;
  * propagation: local `associative_scan` + an all_gather of P partial
    maxima = a cross-shard prefix-max in O(P) scalars of traffic;
  * pointer jumping: one multi-column ring gather per step for
    (phi, cur, resolved) at the jump targets;
  * extension: chunked text-window ring gathers (text rotates as uint8
    blocks), real-text-length guards passed as a dynamic scalar so the
    padded shard shapes stay static;
  * convergence: psum of the unresolved count, checked host-side per
    round (same host-driven structure as core/lcp.py, for the same
    compile-time reason).

Output is bit-identical to core/lcp.py / Kasai on the real text.

**Scale note (CPU-mesh only at benchmark sizes).** Like core/lcp.py's
PLCP round, this program class (scans + pointer-jumping gathers) took
minutes-to-hours to compile at 2^24+ shapes on an earlier accelerator's
remote compiler (host workaround, to be re-justified on the GPU host,
ROADMAP D2). The production route
for large sharded texts is the carried-keys one-pass build with
``want_lcp`` (parallel/bigsort.py), which parallel's build_lcp_array_sharded
routes to above SA_LCP_BIG_MIN; this module remains the general-permutation
fallback and is exercised on the virtual CPU mesh (tests, dryrun).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec

from hpc_suffix_array_tpu.core.suffix_array import as_byte_array, bucket_size
from hpc_suffix_array_tpu.parallel.gather import dist_gather, dist_scatter_perm
from hpc_suffix_array_tpu.parallel.mesh import SEQ_AXIS, make_mesh, sequence_sharding

CMP_WIDTH = 16   # bytes compared per unresolved position per round
JUMP_STEPS = 2


def _gidx(m):
    return lax.axis_index(SEQ_AXIS) * m + lax.iota(jnp.int32, m)


def _setup_local(n_shards, text, sa_pad, n_real):
    """phi + limit from the padded suffix array (pads occupy the SA head)."""
    m = sa_pad.shape[0]
    g = _gidx(m)
    isa = dist_scatter_perm(g, sa_pad, SEQ_AXIS, n_shards)
    phi = dist_gather(sa_pad, isa - 1, SEQ_AXIS, n_shards, fill=-1)
    # Real semantics: a predecessor that is a pad suffix (>= n_real) or
    # missing means plcp = 0 (only the real SA head lands here).
    ok = (phi >= 0) & (phi < n_real) & (g < n_real)
    phi = jnp.where(ok, phi, jnp.int32(-1))
    limit = jnp.where(ok, n_real - jnp.maximum(g, phi), jnp.int32(0))
    return phi, limit


def _prefix_max(z_scan_last, me, n_shards):
    """Max of previous shards' scan totals (exclusive, -inf identity)."""
    gathered = lax.all_gather(z_scan_last, SEQ_AXIS)        # (P,)
    mask = lax.iota(jnp.int32, n_shards) < me
    return jnp.max(jnp.where(mask, gathered, jnp.int32(-2**31 + 1)))


def _round_local(n_shards, nc, text, phi, limit, n_real, cur, resolved):
    """One distributed propagate + jump + extend round."""
    m = cur.shape[0]
    me = lax.axis_index(SEQ_AXIS)
    g = _gidx(m)

    # 1) monotone propagation: plcp[i] + i is non-decreasing on real text.
    z = cur + g
    local = lax.associative_scan(jnp.maximum, z)
    runmax = jnp.maximum(local, _prefix_max(local[-1], me, n_shards))
    prop = jnp.clip(jnp.maximum(cur, runmax - g), 0, limit)
    cur = jnp.where(resolved, cur, prop)
    resolved = resolved | (cur >= limit)

    # 2) pointer jumping along the aligned phi chain (one 3-col gather).
    for _ in range(JUMP_STEPS):
        tgt = g + cur
        cols = jnp.stack([phi, cur, resolved.astype(jnp.int32)], axis=1)
        got = dist_gather(cols, tgt, SEQ_AXIS, n_shards, fill=-1)
        t_phi, t_cur, t_res = got[:, 0], got[:, 1], got[:, 2]
        aligned = (~resolved) & (tgt < n_real) & (t_phi == phi + cur)
        bumped = jnp.minimum(cur + jnp.maximum(t_cur, 0), limit)
        now_exact = aligned & (t_res == 1)
        cur = jnp.where(aligned, bumped, cur)
        resolved = resolved | now_exact | ((~resolved) & (cur >= limit))

    # 3) verified extension, chunked text-window ring gathers.
    chunk = m // nc
    offs = lax.iota(jnp.int32, CMP_WIDTH)[None, :]

    def extend_chunk(args):
        cur_c, phi_c, act_c, g_c = args
        a_pos = g_c[:, None] + cur_c[:, None] + offs
        b_pos = phi_c[:, None] + cur_c[:, None] + offs
        ta = dist_gather(text, a_pos.reshape(-1), SEQ_AXIS, n_shards
                         ).reshape(chunk, CMP_WIDTH)
        tb = dist_gather(text, b_pos.reshape(-1), SEQ_AXIS, n_shards
                         ).reshape(chunk, CMP_WIDTH)
        eq = ((ta == tb) & (a_pos < n_real) & (b_pos < n_real)
              & (b_pos >= 0) & act_c[:, None])
        return jnp.sum(jnp.cumprod(eq.astype(jnp.int32), axis=1), axis=1)

    active = ~resolved
    matched = lax.map(extend_chunk, (
        cur.reshape(nc, chunk), phi.reshape(nc, chunk),
        active.reshape(nc, chunk), g.reshape(nc, chunk))).reshape(m)
    cur = cur + jnp.where(active, matched, 0)
    resolved = resolved | (active & (matched < CMP_WIDTH))

    unresolved = lax.psum(jnp.sum((~resolved).astype(jnp.int32)), SEQ_AXIS)
    return cur, resolved, unresolved == 0


@functools.cache
def _kernels(mesh: Mesh, nc: int):
    S = int(mesh.devices.size)
    spec = PartitionSpec(SEQ_AXIS)
    rep = PartitionSpec()
    setup = jax.jit(jax.shard_map(
        functools.partial(_setup_local, S),
        mesh=mesh, in_specs=(spec, spec, rep), out_specs=(spec, spec),
        check_vma=False))
    rnd = jax.jit(jax.shard_map(
        functools.partial(_round_local, S, nc),
        mesh=mesh,
        in_specs=(spec, spec, spec, rep, spec, spec),
        out_specs=(spec, spec, rep),
        check_vma=False), donate_argnums=(4, 5))
    permute = jax.jit(jax.shard_map(
        lambda plcp, sa_pad: dist_gather(plcp, sa_pad, SEQ_AXIS, S),
        mesh=mesh, in_specs=(spec, spec), out_specs=spec,
        check_vma=False))
    return setup, rnd, permute


def build_lcp_array_sharded(text, sa, mesh: Mesh | None = None) -> jnp.ndarray:
    """LCP array (same contract as core.lcp.build_lcp_array), block-sharded.

    ``sa`` is the real suffix array (int32[n]); internally positions are
    padded to the mesh-aligned bucket with pad suffixes (all ranked below
    real ones) occupying the head of the padded SA in descending position
    order, so real SA neighbors stay adjacent.

    Texts past SA_LCP_BIG_MIN (default 8 MiB) route to the sharded
    carried-keys rebuild (parallel/bigsort.py ``want_lcp``) when it is
    feasible — same rationale as core.lcp.build_lcp_array: the rebuild's
    single distributed sort does in one pass what the PLCP rounds do in
    several. Falls back here on refusal.
    """
    import os

    if mesh is None:
        mesh = make_mesh()
    S = int(mesh.devices.size)
    arr = as_byte_array(text)
    n = int(arr.shape[0])
    if n == 0:
        return jnp.zeros((0,), jnp.int32)

    if n > int(os.environ.get("SA_LCP_BIG_MIN", 1 << 23)) and \
            n < (1 << 31) - 1:           # wide-index can't carry lcp
        from hpc_suffix_array_tpu.core.bigsort import (
            RESIDUE_SLOTS, residue_feasible)
        from hpc_suffix_array_tpu.parallel.bigsort import (
            build_suffix_array_sharded_big)

        host = np.asarray(arr)
        # The per-shard residue caps scale with the mesh size.
        if residue_feasible(host, n, S * RESIDUE_SLOTS / 4):
            try:
                _sa, lcp = build_suffix_array_sharded_big(
                    host, mesh, want_lcp=True)
                return lcp
            except NotImplementedError:
                pass                     # degenerate: PLCP handles any skew

    n_pad = bucket_size(n, multiple_of=S * 128)
    m = n_pad // S
    # chunk count: power of two dividing m, sized so a chunk's text-window
    # requests stay ~1M elements.
    t2 = (m & -m)
    want = max(1, (m * CMP_WIDTH) >> 20)
    nc = 1
    while nc < want and nc < t2:
        nc *= 2

    text_pad = np.zeros(n_pad, np.uint8)
    text_pad[:n] = arr
    sa_pad = np.concatenate([
        np.arange(n_pad - 1, n - 1, -1, dtype=np.int32),
        np.asarray(sa, np.int32)])

    sh = sequence_sharding(mesh)
    text_d = jax.device_put(text_pad, sh)
    sa_d = jax.device_put(sa_pad, sh)
    n_real = jnp.int32(n)

    setup, rnd, permute = _kernels(mesh, nc)
    phi, limit = setup(text_d, sa_d, n_real)

    cur = jax.device_put(np.zeros(n_pad, np.int32), sh)
    resolved = phi < 0
    for _ in range(n // CMP_WIDTH + 2):
        cur, resolved, done = rnd(text_d, phi, limit, n_real, cur, resolved)
        if bool(done):
            break

    # plcp (padded, position order) -> lcp in SA order (still sharded);
    # the real LCP array is the tail slice, with lcp[0] = 0 by contract.
    lcp_pad = permute(cur, sa_d)
    return lcp_pad[n_pad - n:].at[0].set(0)
