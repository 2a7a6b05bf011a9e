"""Worker process for the real 2-process multi-host test.

Each process owns 4 virtual CPU devices (8 global), initializes the JAX
distributed service, feeds ONLY its host-local block of the text via
``put_sharded_text`` (no process ever holds a replicated device copy), and
runs the sharded build over the global mesh. Local output shards are
checked against the SA-IS oracle slice.

This is the JAX analog of the reference's mpirun launch
(scripts/benchmark_mpi.py:59-90): real process boundary, real
coordinator, per-host data feed. Launched by tests/test_multihost.py.

Usage: multihost_worker.py <process_id> <num_processes> <port>
"""

import os
import pathlib
import sys

# python puts the script's dir (tests/) on sys.path, not the repo root.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main() -> int:
    proc_id, nprocs, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(
        coordinator_address=f"localhost:{port}",
        num_processes=nprocs,
        process_id=proc_id)
    assert jax.process_count() == nprocs
    assert jax.local_device_count() == 4
    assert jax.device_count() == 4 * nprocs

    import jax.numpy as jnp
    import numpy as np

    from hpc_suffix_array_tpu.core.oracle import suffix_array_oracle
    from hpc_suffix_array_tpu.core.suffix_array import (
        alphabet_remap, bucket_size)
    from hpc_suffix_array_tpu.parallel.doubling import (
        suffix_array_from_bytes_sharded)
    from hpc_suffix_array_tpu.parallel.multihost import (
        host_local_shard, make_global_mesh, put_sharded_text)

    # Mixed corpus: random head + periodic tail (skewed ranks stress the
    # distributed sort exactly like the reference's repetitive fixtures).
    rng = np.random.default_rng(7)
    text = np.concatenate([
        rng.integers(0, 256, 30_000).astype(np.uint8),
        np.tile(np.frombuffer(b"ab", np.uint8), 10_000),
    ])
    n = len(text)

    mesh = make_global_mesh()
    n_shards = int(mesh.devices.size)
    assert n_shards == 4 * nprocs
    n_pad = bucket_size(n, multiple_of=n_shards * 128)
    text_pad = np.zeros(n_pad, np.uint8)
    text_pad[:n] = text
    remap, bits, h0 = alphabet_remap(text)

    # Per-host feed: only this host's block leaves host memory.
    start, stop = host_local_shard(n_pad, mesh)
    assert stop - start == n_pad // nprocs
    text_d = put_sharded_text(text_pad, mesh)

    sa, _rank, rounds = suffix_array_from_bytes_sharded(mesh, bits, h0)(
        text_d, jnp.asarray(remap), jnp.int32(n))

    # The kernel's contract covers the REAL tail slice [n_pad-n, n_pad)
    # (pad suffixes sort first but their internal order is unspecified -
    # build_suffix_array_sharded slices them off). Check every local
    # shard's overlap with the real region against the SA-IS oracle.
    expected_real = np.asarray(suffix_array_oracle(text.tobytes()), np.int32)
    pad = n_pad - n
    checked = 0
    for shard in sa.addressable_shards:
        lo, hi = shard.index[0].start or 0, shard.index[0].stop
        got = np.asarray(shard.data)
        if hi <= pad:
            continue
        cut = max(pad - lo, 0)
        want = expected_real[lo + cut - pad:hi - pad]
        assert np.array_equal(got[cut:], want), (
            f"proc {proc_id} shard [{lo},{hi}) mismatch")
        checked += hi - (lo + cut)
    assert checked > 0

    print(f"MULTIHOST_OK proc={proc_id} rounds={int(rounds)} "
          f"shards={len(sa.addressable_shards)}", flush=True)

    # ---- One-pass MSD across the same REAL process boundary ----------
    # (build_suffix_array_sharded_big_mp: device-histogram alphabet,
    # allgathered repeat estimate, ring-rotation period check,
    # window-gather residue resolution — no process holds the text.)
    from hpc_suffix_array_tpu.core.oracle import lcp_oracle
    from hpc_suffix_array_tpu.parallel.bigsort import (
        build_suffix_array_sharded_big_mp, mp_local_geometry)

    def local_feed(text, n_pad, start, stop):
        """What a real deployment would read from its own file block."""
        pad = np.zeros(n_pad, np.uint8)
        pad[:len(text)] = text
        return pad[start:stop]

    def check_shards(col, want, name, scale=None, col_lo=None):
        """Each process checks only its ADDRESSABLE shards vs oracle."""
        checked = 0
        for shard in col.addressable_shards:
            lo, hi = shard.index[0].start or 0, shard.index[0].stop
            got = np.asarray(shard.data).astype(np.int64)
            if scale is not None:       # wide: combine hi/lo columns
                lo_shard = next(s for s in col_lo.addressable_shards
                                if (s.index[0].start or 0) == lo)
                got = got * scale + np.asarray(lo_shard.data)
            take = min(hi, len(want)) - lo
            if take <= 0:
                continue
            assert np.array_equal(got[:take], want[lo:lo + take]), (
                f"proc {proc_id} {name} shard [{lo},{hi}) mismatch")
            checked += take
        assert checked > 0, f"proc {proc_id} {name}: nothing checked"

    # (a) narrow + LCP: random text with a 100-byte repeated block —
    # the local estimate mispredicts chain, the device period check
    # refuses it, the ascending retry resolves residue ties through
    # distributed window gathers (incl. deep >64-byte windows).
    alnum = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
        np.uint8)
    t_a = alnum[rng.integers(0, 62, 8 * 4096)]
    t_a[2000:2100] = t_a[20000:20100]
    n_a = len(t_a)
    n_pad, start, stop = mp_local_geometry(n_a, mesh)
    sa_pad, lcp_pad = build_suffix_array_sharded_big_mp(
        local_feed(t_a, n_pad, start, stop), n_a, mesh, want_lcp=True)
    want_a = np.asarray(suffix_array_oracle(t_a.tobytes()), np.int64)
    check_shards(sa_pad, want_a, "msd-sa")
    check_shards(lcp_pad, np.asarray(lcp_oracle(t_a, want_a), np.int64),
                 "msd-lcp")

    # (b) globally periodic: the device-side period check must ACCEPT
    # the chain (no host text anywhere).
    t_b = np.tile(alnum[rng.integers(0, 62, 1000)], 40)[: 8 * 4096]
    n_b = len(t_b)
    n_pad, start, stop = mp_local_geometry(n_b, mesh)
    sa_pad = build_suffix_array_sharded_big_mp(
        local_feed(t_b, n_pad, start, stop), n_b, mesh)
    check_shards(sa_pad,
                 np.asarray(suffix_array_oracle(t_b.tobytes()), np.int64),
                 "msd-chain")

    # (c) forced wide index + LCP: two-word device columns, residue
    # patched per shard on device.
    t_c = alnum[rng.integers(0, 62, 8 * 2048)]
    t_c[700:780] = t_c[9000:9080]
    n_c = len(t_c)
    n_pad, start, stop = mp_local_geometry(n_c, mesh)
    (s_hi, s_lo), (l_hi, l_lo) = build_suffix_array_sharded_big_mp(
        local_feed(t_c, n_pad, start, stop), n_c, mesh,
        wide_index=True, want_lcp=True)
    m_c = n_pad // n_shards
    want_c = np.asarray(suffix_array_oracle(t_c.tobytes()), np.int64)
    check_shards(s_hi, want_c, "msd-wide-sa", scale=m_c, col_lo=s_lo)
    check_shards(l_hi, np.asarray(lcp_oracle(t_c, want_c), np.int64),
                 "msd-wide-lcp", scale=m_c, col_lo=l_lo)

    # (d) min-pad packing family (power-of-two alphabet): sigma=4 from
    # the device histogram selects 2-bit minpad codes. A long run of
    # the MINIMUM symbol at the text end makes real suffixes pack to
    # all-zero keys — the shard-0 boundary case whose manufactured
    # predecessor also carries key 0 (see parallel/bigsort._boundary_
    # prev) — and a planted repeat forces residue ties resolved through
    # the window gathers under minpad (clamped LCP at group edges).
    dna = np.frombuffer(b"ACGT", np.uint8)
    t_d = dna[rng.integers(0, 4, 8 * 4096)]
    t_d[1000:1100] = t_d[17000:17100]
    t_d[-600:] = ord("A")               # min symbol tail run
    n_d = len(t_d)
    n_pad, start, stop = mp_local_geometry(n_d, mesh)
    sa_pad, lcp_pad = build_suffix_array_sharded_big_mp(
        local_feed(t_d, n_pad, start, stop), n_d, mesh, want_lcp=True)
    want_d = np.asarray(suffix_array_oracle(t_d.tobytes()), np.int64)
    check_shards(sa_pad, want_d, "msd-minpad-sa")
    check_shards(lcp_pad, np.asarray(lcp_oracle(t_d, want_d), np.int64),
                 "msd-minpad-lcp")

    print(f"MULTIHOST_MSD_OK proc={proc_id}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
