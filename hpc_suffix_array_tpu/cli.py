"""Command-line entry point: `sa-cli`.

UX parity with the reference CLIs while collapsing both into one program:

  * single positional arg with the file-vs-string heuristic — an argument
    containing '/' or '.' is a file path, otherwise a literal string
    (reference src/sequential/main_sequential.c:65-95);
  * human-readable results: validity, LRS, per-phase timings
    (main_sequential.c:119-135), and the n<=100 detailed SA/LCP dump
    (main_sequential.c:137-149);
  * machine-readable STRUCTURED_RESULTS blocks in both reference dialects:
    `===STRUCTURED_RESULTS===` (sequential, main_sequential.c:38-50) and
    `--- STRUCTURED_RESULTS ---` (MPI, src/mpi/main_mpi.c:94-100), so the
    reference's regex-based benchmark harness contract survives verbatim.

Unlike the reference (zero flags, SURVEY §5 "Config / flag system: None"),
backend, mesh size, validation, and output dialect are real flags.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def looks_like_file(arg: str) -> bool:
    """The reference's heuristic: '/' or '.' means file (main_sequential.c:65)."""
    return "/" in arg or "." in arg


def _fence(x):
    import jax
    return jax.block_until_ready(x)


def run(text: np.ndarray, filename: str, backend: str, n_devices: int | None,
        validate: bool, dialect: str, out=None) -> dict:
    """Build SA + LCP + LRS with per-phase timing; print the full report.

    Returns the structured-results dict (also printed as text blocks).
    """
    import jax

    out = out if out is not None else sys.stdout

    from hpc_suffix_array_tpu.core.lcp import build_lcp_array
    from hpc_suffix_array_tpu.core.lrs import find_longest_repeated_substring
    from hpc_suffix_array_tpu.core.suffix_array import build_suffix_array
    from hpc_suffix_array_tpu.core.validate import is_valid_suffix_array

    n = int(text.shape[0])
    n_procs = 1
    mesh = None

    combined = None
    info: dict = {}
    t0 = time.perf_counter()
    if backend == "sharded":
        import os as _os

        from hpc_suffix_array_tpu.parallel import (
            build_sa_lcp_sharded, build_suffix_array_sharded, make_mesh)
        mesh = make_mesh(n_devices)
        n_procs = int(mesh.devices.size)
        if n > int(_os.environ.get("SA_SHARDED_MSD_MIN", 1 << 22)):
            # Fused sharded SA+LCP (one carried-keys pass, r5) — the
            # distributed analog of the single-backend fused route.
            combined = build_sa_lcp_sharded(text, mesh, info=info)
            sa = _fence(combined[0])
        else:
            sa = _fence(build_suffix_array_sharded(text, mesh,
                                                   info=info))
    else:
        import os as _os

        if n > int(_os.environ.get("SA_LCP_BIG_MIN", 1 << 23)):
            # One carried-keys pass yields SA and LCP together — at
            # these sizes a standalone LCP pass would redo the same
            # full-text sort (see core/lcp.build_lcp_array). The fused
            # router serves BOTH carried-keys builders (direct through
            # SA_DIRECT_CROSS, the fine-geometry MSD above — the r4
            # crossover), where routing only the direct path here left
            # every MSD-class file paying the full build twice. In the
            # rare case the router's internal fallback builds SA and
            # LCP separately, both land in the SA phase below — the
            # timing split favors honesty about the fused path over
            # attributing a synthetic LCP_TIME.
            from hpc_suffix_array_tpu.core.lcp import build_sa_lcp

            combined = build_sa_lcp(text, info=info)
        sa = _fence(combined[0] if combined is not None
                    else build_suffix_array(text, info=info))
    t1 = time.perf_counter()

    if combined is not None:
        lcp = _fence(combined[1])
    elif mesh is not None:
        from hpc_suffix_array_tpu.parallel import build_lcp_array_sharded
        lcp = _fence(build_lcp_array_sharded(text, sa, mesh))
    else:
        lcp = _fence(build_lcp_array(text, sa))
    lrs = find_longest_repeated_substring(text, sa, lcp)
    t2 = time.perf_counter()

    sa_time, lcp_time, total_time = t1 - t0, t2 - t1, t2 - t0

    if not validate:
        valid = None
    elif mesh is not None:
        from hpc_suffix_array_tpu.parallel import (
            is_valid_suffix_array_sharded)
        valid = is_valid_suffix_array_sharded(text, sa, mesh)
    else:
        valid = is_valid_suffix_array(text, sa)

    print("\n=== RESULTS ===", file=out)
    if validate:
        print(f"Valid suffix array: {'YES' if valid else 'NO'}", file=out)
    if lrs:
        shown = lrs.decode("utf-8", errors="replace")
        print(f"Longest repeated substring: '{shown}' (length: {len(lrs)})",
              file=out)
    else:
        print("No repeated substring found", file=out)
    print(f"Suffix array construction time: {sa_time:.6f} seconds", file=out)
    print(f"LCP construction + LRS search time: {lcp_time:.6f} seconds",
          file=out)
    print(f"Total execution time: {total_time:.6f} seconds", file=out)

    if n <= 100:
        _detail_dump(text, np.asarray(sa), np.asarray(lcp), out)

    from hpc_suffix_array_tpu.utils.runtime import platform_label

    results = {
        "implementation": platform_label(
            None if backend == "single" else n_procs),
        "filename": filename,
        "file_size": n,
        "total_time": total_time,
        "sa_time": sa_time,
        "lcp_time": lcp_time,
        "processes": n_procs,
        "valid": valid,
        "lrs_length": len(lrs) if lrs else 0,
    }
    if info.get("path"):
        # Observability: which builder served the request (direct /
        # msd / doubling) — extra STRUCTURED key, ignored by the
        # reference-dialect regex parsers like RERUN below.
        results["path"] = info["path"]
    if info.get("rerun"):
        # Honesty key: a routing misprediction (chain direction or
        # count-free capacity overflow) re-executed the build's passes;
        # the reported SA_TIME includes that re-run.
        results["rerun"] = ",".join(info["rerun"])
    _print_structured(results, dialect, out)
    return results


def _detail_dump(text: np.ndarray, sa: np.ndarray, lcp: np.ndarray, out):
    """Small-input detail block (reference main_sequential.c:137-149)."""
    n = len(text)
    print("\n=== DETAILED ANALYSIS ===", file=out)
    print(f"Suffix array ({n} entries):", file=out)
    for j in range(min(n, 10)):
        s = bytes(text[sa[j]:sa[j] + 30]).decode("utf-8", errors="replace")
        ell = "..." if n - sa[j] > 30 else ""
        print(f'  sa[{j}] = {sa[j]:3d}  "{s}{ell}"', file=out)
    shown = ", ".join(str(int(v)) for v in lcp[:20])
    suffix = ", ..." if n > 20 else ""
    print(f"\nLCP Array: [{shown}{suffix}]", file=out)


def _print_structured(r: dict, dialect: str, out) -> None:
    if dialect in ("sequential", "both"):
        print("\n===STRUCTURED_RESULTS===", file=out)
        print(f"IMPLEMENTATION:{r['implementation']}", file=out)
        print(f"FILENAME:{r['filename']}", file=out)
        print(f"FILE_SIZE:{r['file_size']}", file=out)
        print(f"TOTAL_TIME:{r['total_time']:.6f}", file=out)
        print(f"SA_TIME:{r['sa_time']:.6f}", file=out)
        print(f"LCP_TIME:{r['lcp_time']:.6f}", file=out)
        print(f"PROCESSES:{r['processes']}", file=out)
        if r.get("path"):
            print(f"PATH:{r['path']}", file=out)
        if r.get("rerun"):
            print(f"RERUN:{r['rerun']}", file=out)
        print("===END_RESULTS===\n", file=out)
    if dialect in ("mpi", "both"):
        print("\n--- STRUCTURED_RESULTS ---", file=out)
        print(f"ACTUAL_STRING_LENGTH:{r['file_size']}", file=out)
        print(f"MPI_PROCESSES:{r['processes']}", file=out)
        print(f"SA_TIME:{r['sa_time']:.6f}", file=out)
        print(f"LCP_TIME:{r['lcp_time']:.6f}", file=out)
        print(f"TOTAL_TIME:{r['total_time']:.6f}", file=out)
        if r.get("rerun"):
            print(f"RERUN:{r['rerun']}", file=out)
        print("--- END_STRUCTURED_RESULTS ---", file=out)


def main(argv=None) -> int:
    # SA_PLATFORM=cpu forces the backend even where jax was pre-imported
    # before the process env could be changed (JAX_PLATFORMS is snapshotted
    # at jax import time; jax.config.update works until first backend use).
    import os

    plat = os.environ.get("SA_PLATFORM")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)

    p = argparse.ArgumentParser(
        prog="sa-cli",
        description="Suffix array / LCP / LRS on an accelerator "
                    "(capabilities of a-rtemis99/hpc_suffix_array)")
    p.add_argument("input",
                   help="input file path or literal string; an argument "
                        "containing '/' or '.' is treated as a file")
    p.add_argument("--backend", choices=["single", "sharded"],
                   default="single",
                   help="single-device kernel or mesh-sharded build")
    p.add_argument("--devices", type=int, default=None,
                   help="mesh size for --backend sharded (default: all)")
    p.add_argument("--no-validate", action="store_true",
                   help="skip the O(n) self-validation pass")
    p.add_argument("--dialect", choices=["sequential", "mpi", "both"],
                   default=None,
                   help="STRUCTURED_RESULTS dialect to emit (default: "
                        "sequential; mpi under --distributed)")
    p.add_argument("--distributed", action="store_true",
                   help="multi-process worker mode: initialize "
                        "jax.distributed and run the one-pass MSD build "
                        "with per-process block feeds (the reference's "
                        "mpirun model, src/mpi/main_mpi.c)")
    p.add_argument("--spawn", type=int, metavar="P", default=None,
                   help="launcher (mpirun analog): spawn P --distributed "
                        "worker processes on a free local port and wait")
    p.add_argument("--processes", type=int, default=None,
                   help="total process count for --distributed "
                        "(or SA_NUM_PROCESSES)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's id for --distributed "
                        "(or SA_PROCESS_ID)")
    p.add_argument("--coordinator", default=None,
                   help="host:port of the jax.distributed coordinator "
                        "for --distributed (or SA_COORDINATOR)")
    p.add_argument("--devices-per-process", type=int, default=2,
                   help="virtual CPU devices per worker under "
                        "SA_PLATFORM=cpu (the oversubscribe analog); "
                        "ignored on GPUs, where each worker takes one card")
    p.add_argument("--string", action="store_true",
                   help="force the argument to be a literal string")
    p.add_argument("--file", dest="force_file", action="store_true",
                   help="force the argument to be a file path")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="write a jax.profiler device trace to DIR "
                        "(TensorBoard profile plugin)")
    args = p.parse_args(argv)
    if args.dialect is None:
        args.dialect = "mpi" if (args.distributed
                                 or args.spawn) else "sequential"
    if args.spawn:
        from hpc_suffix_array_tpu.cli_distributed import spawn
        return spawn(args, [])
    if args.distributed:
        from hpc_suffix_array_tpu.cli_distributed import run_distributed
        return run_distributed(args)

    from hpc_suffix_array_tpu.utils.io import (
        print_first_chars, print_last_chars, read_file)
    from hpc_suffix_array_tpu.utils.runtime import (
        enable_compile_cache, platform_label)

    enable_compile_cache()

    is_file = (args.force_file
               or (looks_like_file(args.input) and not args.string))
    if is_file:
        print(f"Reading from file: {args.input}")
        try:
            text = read_file(args.input)
        except OSError as e:
            print(f"Error: Failed to read input file: {e}", file=sys.stderr)
            return 1
        filename = args.input
        n = len(text)
        print(f"File read successfully: {args.input}")
        print(f"Actual string length: {n}")
        if n < 100:
            print(f'Full content: "{bytes(text).decode("utf-8", "replace")}"')
        else:
            print_first_chars(text, 50)
            print_last_chars(text, 50)
        print()
    else:
        raw = args.input.encode("utf-8")
        text = np.frombuffer(raw, np.uint8)
        filename = "direct_string"
        print(f"Input string: {args.input}")
        print(f"String length: {len(text)}")

    try:
        if args.trace:
            from hpc_suffix_array_tpu.utils.profiling import device_trace
            with device_trace(args.trace):
                run(text, filename, args.backend, args.devices,
                    validate=not args.no_validate, dialect=args.dialect)
            print(f"device trace written to {args.trace}")
        else:
            run(text, filename, args.backend, args.devices,
                validate=not args.no_validate, dialect=args.dialect)
    except KeyboardInterrupt:
        raise
    except Exception as e:
        # The reference CLI never crashes with a traceback on a valid
        # input (src/sequential/main_sequential.c:52-162); with the r5
        # fallback chain (refinement -> doubling -> host SA-IS) builds
        # should not fail either, so anything arriving here is
        # environmental (OOM, device loss). Emit an actionable error
        # plus a parseable FAILED block and a nonzero exit so the bench
        # harness records a FAILED row instead of a stack trace.
        msg = str(e).splitlines()[0][:200] if str(e) else ""
        print(f"Error: build failed: {type(e).__name__}: {msg}",
              file=sys.stderr)
        print("\n===STRUCTURED_RESULTS===")
        print(f"IMPLEMENTATION:{platform_label()}")
        print(f"FILENAME:{filename}")
        print(f"FILE_SIZE:{len(text)}")
        print("STATUS:FAILED")
        print(f"ERROR:{type(e).__name__}")
        print("===END_RESULTS===")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
