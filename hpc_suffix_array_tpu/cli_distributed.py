"""Multi-process CLI: the accelerator analog of ``mpirun -np P ./bin/main_mpi``.

The reference's distributed UX is ``mpirun -np P ./bin/main_mpi file``
(scripts/benchmark_mpi.py:59-90; src/mpi/main_mpi.c:13-116): P OS
processes, a coordinator, STRUCTURED_RESULTS printed by rank 0.  This
module gives ``sa-cli`` the same two surfaces:

  * **worker** — ``sa-cli FILE --distributed --processes P
    --process-id I --coordinator HOST:PORT``: initializes
    ``jax.distributed``, reads ONLY this process's block of the file
    (``mp_local_geometry``; the reference instead broadcasts the whole
    text to every rank, main_mpi.c:43-51), runs the one-pass MSD
    ``build_suffix_array_sharded_big_mp`` over the global mesh (the
    doubling builder as fallback), computes the LRS with global-array
    reductions, and prints the MPI-dialect STRUCTURED_RESULTS block on
    process 0.  Flags can also come from the environment
    (SA_NUM_PROCESSES / SA_PROCESS_ID / SA_COORDINATOR) so torchrun-
    style launchers work.
  * **launcher** — ``sa-cli FILE --distributed --spawn P``: the mpirun
    analog; spawns P worker processes of this same CLI on a free local
    port, streams process 0's output, and propagates the worst exit
    code.

Workers run on the platform JAX finds. On GPUs the launcher gives
worker ``i`` only card ``i`` (``CUDA_VISIBLE_DEVICES``): one process per
card, since a JAX process reserves most of the memory of every card it
can see. ``SA_PLATFORM=cpu`` runs the workers on the CPU backend instead,
with ``--devices-per-process`` virtual devices each (the analog of the
reference harness's ``--oversubscribe``, benchmark_mpi.py:61); the tests
and the Makefile pass it explicitly.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

import numpy as np


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_env(i: int, environ=None) -> dict:
    """Environment of spawned worker ``i``: the launcher's own, plus
    ``CUDA_VISIBLE_DEVICES=i`` unless the workers run on the CPU
    (``SA_PLATFORM=cpu``). The platform itself is never forced."""
    env = dict(os.environ if environ is None else environ)
    if env.get("SA_PLATFORM", "") != "cpu":
        env["CUDA_VISIBLE_DEVICES"] = str(i)
    return env


def spawn(args, argv_rest: list[str]) -> int:
    """Launch P worker processes of this CLI (the mpirun analog)."""
    P = int(args.spawn)
    port = _free_port()
    procs = []
    for i in range(P):
        cmd = [sys.executable, "-m", "hpc_suffix_array_tpu.cli",
               args.input, "--distributed",
               "--processes", str(P), "--process-id", str(i),
               "--coordinator", f"127.0.0.1:{port}",
               "--devices-per-process", str(args.devices_per_process),
               "--dialect", args.dialect]
        if args.no_validate:
            cmd.append("--no-validate")
        if args.string:
            cmd.append("--string")
        if args.force_file:
            cmd.append("--file")
        procs.append(subprocess.Popen(
            cmd, env=worker_env(i),
            stdout=None if i == 0 else subprocess.DEVNULL,
            stderr=None if i == 0 else subprocess.STDOUT))
    rc = 0
    for p in procs:
        code = p.wait()
        if code != 0:
            # Popen.wait() returns NEGATIVE codes for signal deaths
            # (e.g. -9 for an OOM kill) — max() against a clean 0 would
            # mask them; any nonzero worker fails the launch.
            rc = max(rc, abs(code), 1)
    return rc


def run_distributed(args) -> int:
    """Worker body (one of P processes).  Returns the process exit code."""
    P = int(args.processes or os.environ.get("SA_NUM_PROCESSES", 0))
    pid = int(args.process_id
              if args.process_id is not None
              else os.environ.get("SA_PROCESS_ID", -1))
    coord = (args.coordinator or os.environ.get("SA_COORDINATOR")
             or "127.0.0.1:12355")
    if P <= 0 or pid < 0:
        print("Error: --distributed needs --processes/--process-id (or "
              "SA_NUM_PROCESSES/SA_PROCESS_ID), or use --spawn P",
              file=sys.stderr)
        return 2

    # Backend setup must precede first jax backend use. CPU workers
    # (SA_PLATFORM=cpu) get --devices-per-process virtual devices
    # (tests/multihost_worker.py pattern); elsewhere the worker takes
    # the platform JAX finds and the devices its launcher left visible.
    import re as _re

    plat = os.environ.get("SA_PLATFORM")
    if plat == "cpu":
        dpp = int(args.devices_per_process)
        flags = _re.sub(r"--xla_force_host_platform_device_count=\d+", "",
                        os.environ.get("XLA_FLAGS", ""))
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={dpp}"
        ).strip()

    import jax

    if plat:
        jax.config.update("jax_platforms", plat)
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=P, process_id=pid)
    from hpc_suffix_array_tpu.utils.runtime import (
        enable_compile_cache, platform_label)

    enable_compile_cache()

    import jax.numpy as jnp
    from jax import lax

    from hpc_suffix_array_tpu.parallel.bigsort import (
        build_suffix_array_sharded_big_mp, mp_local_geometry)
    from hpc_suffix_array_tpu.parallel.multihost import make_global_mesh

    root = pid == 0
    out = sys.stdout if root else open(os.devnull, "w")

    # ---- input: every process sees the file; each reads its block ----
    from hpc_suffix_array_tpu.cli import looks_like_file

    is_file = (args.force_file
               or (looks_like_file(args.input) and not args.string))
    if is_file:
        try:
            n = os.path.getsize(args.input)
        except OSError as e:
            print(f"Error: Failed to read input file: {e}",
                  file=sys.stderr)
            return 1
        filename = args.input
        print(f"Reading from file: {args.input}", file=out)
        print(f"Actual string length: {n}", file=out)
    else:
        literal = args.input.encode("utf-8")
        n = len(literal)
        filename = "direct_string"
        print(f"Input string: {args.input}", file=out)
        print(f"String length: {n}", file=out)

    mesh = make_global_mesh()
    n_pad, start, stop = mp_local_geometry(n, mesh)
    block = np.zeros(stop - start, np.uint8)
    if is_file:
        # Block read: only [start, stop) ∩ [0, n) of the file touches
        # this process — the reference broadcasts the full text to every
        # rank instead (main_mpi.c:43-51).
        take = max(0, min(n, stop) - start)
        if take:
            with open(args.input, "rb") as f:
                f.seek(start)
                block[:take] = np.frombuffer(f.read(take), np.uint8)
    else:
        arr = np.frombuffer(literal, np.uint8)
        take = max(0, min(n, stop) - start)
        if take:
            block[:take] = arr[start:start + take]

    def _fence(x):
        # Completion fence on a sharded array: fetch one element of a
        # locally-addressable shard (block_until_ready is an enqueue
        # fence on some transports).
        sh = x.addressable_shards[0].data
        import jax as _j
        _j.device_get(sh[-1:])

    # ---- build: one-pass MSD, doubling as the any-skew fallback ------
    t0 = time.time()
    path = "sharded_msd_mp"
    try:
        sa_pad, lcp_pad = build_suffix_array_sharded_big_mp(
            block, n, mesh, want_lcp=True)
        _fence(sa_pad)
        _fence(lcp_pad)
    except (NotImplementedError, ValueError):
        # Doubling fallback needs the replicated text (exactly the
        # reference's own model) plus a separate LCP pass.
        path = "sharded_doubling"
        from hpc_suffix_array_tpu.core.suffix_array import (
            alphabet_remap, bucket_size)
        from hpc_suffix_array_tpu.parallel import build_lcp_array_sharded
        from hpc_suffix_array_tpu.parallel.doubling import (
            build_suffix_array_sharded)

        if is_file:
            with open(args.input, "rb") as f:
                full = np.frombuffer(f.read(), np.uint8)
        else:
            full = np.frombuffer(literal, np.uint8)
        sa = build_suffix_array_sharded(full, mesh)
        _fence(sa)
        t1 = time.time()
        lcp = build_lcp_array_sharded(full, sa, mesh)
        _fence(lcp)
        sa_pad, lcp_pad = sa, lcp
    else:
        t1 = time.time()

    # ---- LRS via global-array reductions (replicated scalars) --------
    @jax.jit
    def lrs_stats(sa, lcp):
        L = lcp.shape[0]
        iota = lax.iota(jnp.int32, L)
        masked = jnp.where(iota < n, lcp, -1)
        j = jnp.argmax(masked)
        return masked[j], sa[j]

    lrs_len, lrs_start = (int(x) for x in
                          jax.device_get(lrs_stats(sa_pad, lcp_pad)))
    t2 = time.time()
    # Fused-route attribution (same policy as the sequential CLI): the
    # mp build derives SA and LCP in one pass, timed as SA_TIME; the
    # LRS reduction is the LCP/LRS phase.
    sa_time, lcp_time, total_time = t1 - t0, t2 - t1, t2 - t0

    valid = None
    if not args.no_validate:
        # Opt-out validation: gather the SA (the collective needs every
        # process) and check on process 0 with the native O(n) validator
        # against the file bytes — the reference's root-validate model
        # (main_mpi.c:78).
        from jax.experimental import multihost_utils

        sa_host = np.asarray(multihost_utils.process_allgather(
            sa_pad, tiled=True))[:n]
        if root:
            if is_file:
                with open(args.input, "rb") as f:
                    full = np.frombuffer(f.read(), np.uint8)
            else:
                full = np.frombuffer(literal, np.uint8)
            from hpc_suffix_array_tpu.native import available, sa_validate
            if available():
                valid = bool(sa_validate(full, sa_host))
            else:
                from hpc_suffix_array_tpu.core.validate import (
                    is_valid_suffix_array)
                valid = bool(is_valid_suffix_array(full, sa_host))

    print("\n=== RESULTS ===", file=out)
    if valid is not None:
        print(f"Valid suffix array: {'YES' if valid else 'NO'}", file=out)
    if lrs_len > 0:
        if is_file:
            with open(args.input, "rb") as f:
                f.seek(lrs_start)
                lrs = f.read(lrs_len)
        else:
            lrs = literal[lrs_start:lrs_start + lrs_len]
        shown = lrs.decode("utf-8", errors="replace")
        print(f"Longest repeated substring: '{shown}' "
              f"(length: {lrs_len})", file=out)
    else:
        print("No repeated substring found", file=out)
    print(f"Suffix array construction time: {sa_time:.6f} seconds",
          file=out)
    print(f"LCP construction + LRS search time: {lcp_time:.6f} seconds",
          file=out)
    print(f"Total execution time: {total_time:.6f} seconds", file=out)

    results = {
        "implementation": platform_label(P),
        "filename": filename,
        "file_size": n,
        "total_time": total_time,
        "sa_time": sa_time,
        "lcp_time": lcp_time,
        "processes": P,
        "valid": valid,
        "lrs_length": lrs_len,
        "path": path,
    }
    if root:
        from hpc_suffix_array_tpu.cli import _print_structured
        _print_structured(results, args.dialect, sys.stdout)
    if valid is False:
        return 1
    return 0
