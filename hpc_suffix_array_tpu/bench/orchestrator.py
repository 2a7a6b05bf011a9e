"""Benchmark orchestrator: datasets -> sweeps -> CSVs -> charts -> reports.

Parity with scripts/run_all_benchmarks.py:16-88, with environment-based
backend selection: the reference keys on `/kaggle` existing (:12-14) to
pick its CUDA harness; here we key on whether an accelerator is attached
(`jax.devices()`), which selects the single-device path, and mesh sizes
come from the actual local device count. In-process calls replace the
reference's per-script subprocess boundary, so one Python failure cannot
silently zero a whole backend's results.

Run: ``python -m hpc_suffix_array_tpu.bench.orchestrator [--quick]``
"""

from __future__ import annotations

import argparse
import sys
import traceback


def detect_environment() -> dict:
    import jax

    devices = jax.devices()
    platforms = {d.platform for d in devices}
    return {
        "devices": len(devices),
        "platforms": sorted(platforms),
        "accelerator": any(p not in ("cpu",) for p in platforms),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="sa-bench-all")
    p.add_argument("--quick", action="store_true",
                   help="small fixtures only (CI-sized run)")
    p.add_argument("--data-dir", default="test_data")
    p.add_argument("--results-dir", default="results/benchmarks")
    p.add_argument("--charts-dir", default="results/charts")
    p.add_argument("--random-mb", type=int, nargs="*", default=[1, 50, 100])
    args = p.parse_args(argv)

    from hpc_suffix_array_tpu.bench.harness import benchmark_corpora

    def _twin_parses(path) -> bool:
        import os
        import re

        return re.match(r"(random|repetitive|dna)_(\d+)MB",
                        os.path.basename(str(path))) is not None
    from hpc_suffix_array_tpu.bench.micro import run_micro_benchmark
    from hpc_suffix_array_tpu.datasets.generate import (
        generate_standard_datasets, generate_test_fixtures)
    from hpc_suffix_array_tpu.viz import (
        generate_comparative_charts, generate_multi_backend_report,
        generate_performance_charts, generate_phase_breakdown_chart,
        generate_statistics_report)

    env = detect_environment()
    print(f"environment: {env}")
    steps, failures = [], []

    def step(name, fn):
        print(f"\n=== {name} ===")
        try:
            out = fn()
            steps.append((name, True))
            return out
        except Exception:
            traceback.print_exc()
            steps.append((name, False))
            failures.append(name)
            return None

    fixtures = step("generate fixtures",
                    lambda: generate_test_fixtures(args.data_dir)) or []
    if not args.quick:
        corpora = step(
            "generate corpora",
            lambda: generate_standard_datasets(
                args.data_dir, random_mb=tuple(args.random_mb),
                repetitive_mb=(1,), dna_mb=(10,))) or []
    else:
        corpora = []

    step("micro benchmark",
         lambda: run_micro_benchmark(
             out_csv=f"{args.results_dir}/micro_results.csv",
             sizes=(1_000, 10_000, 100_000) if args.quick else None or
             (1_000, 5_000, 10_000, 50_000, 100_000, 500_000, 1_000_000),
             reps=1 if args.quick else 3))

    # mesh sweep: single device plus power-of-two meshes up to local count
    # (the analog of the reference's -np {2,4,8}, benchmark_mpi.py:154)
    sizes = [None]
    d = 2
    while d <= env["devices"]:
        sizes.append(d)
        d *= 2
    files = fixtures if args.quick else list(corpora)
    step("corpus sweep",
         lambda: benchmark_corpora(files, results_dir=args.results_dir,
                                   mesh_sizes=tuple(sizes)))
    if not args.quick:
        # Same sweep with device-born twin corpora: the file sweep above
        # proves the IO contract; this one times the build without its
        # host->device staging.
        step("twin corpus sweep",
             lambda: benchmark_corpora(
                 [f for f in files if _twin_parses(f)],
                 results_dir=args.results_dir, mesh_sizes=(None,),
                 seq_csv_name="sequential_results_twin.csv", twin=True))

    step("performance charts",
         lambda: generate_performance_charts(
             f"{args.results_dir}/sequential_results.csv", args.charts_dir))
    step("phase breakdown chart",
         lambda: generate_phase_breakdown_chart(
             f"{args.results_dir}/sequential_results.csv", args.charts_dir))
    step("comparative charts",
         lambda: generate_comparative_charts(args.results_dir,
                                             args.charts_dir))
    step("statistics report",
         lambda: generate_statistics_report(
             f"{args.results_dir}/sequential_results.csv"))
    step("multi-backend report",
         lambda: generate_multi_backend_report(args.results_dir))

    print("\n=== SUMMARY ===")
    for name, ok in steps:
        print(f"  {'PASS' if ok else 'FAIL'}  {name}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
