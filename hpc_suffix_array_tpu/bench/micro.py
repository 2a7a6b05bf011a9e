"""In-framework micro-benchmark sweep (C suite parity).

Mirrors the reference driver src/benchmark/main_benchmark.c:5-56: size
sweep {1e3, 5e3, 1e4, 5e4, 1e5, 5e5, 1e6} x 3 repetitions on random text
(:9-11), plus the repetitive family from suffix_array_benchmark.c:110-123,
written to a CSV with the exact reference header
(suffix_array_benchmark.c:78).
"""

from __future__ import annotations

import csv
import pathlib

from hpc_suffix_array_tpu.bench.timing import BenchmarkResult, run_benchmark
from hpc_suffix_array_tpu.datasets.generate import (
    generate_random_text, generate_repetitive_text)
from hpc_suffix_array_tpu.utils.runtime import platform_label

# reference main_benchmark.c:9-11
SIZES = (1_000, 5_000, 10_000, 50_000, 100_000, 500_000, 1_000_000)
REPS = 3

# Reference header (suffix_array_benchmark.c:78) + one extra trailing
# column: compile_time. The C suite had no JIT; recording XLA compile cost
# in-row would poison every small-n timing (a 1-time ~seconds compile vs
# microseconds of run), so run_benchmark warms up first and reports the
# compile separately.
CSV_HEADER = ["implementation", "input_type", "string_length", "total_time",
              "sa_time", "lcp_time", "lrs_time", "memory_used",
              "compile_time"]


def run_micro_benchmark(out_csv="results/csv/benchmark_results.csv",
                        sizes=SIZES, reps: int = REPS, mesh=None,
                        input_types=("random", "repetitive"),
                        verbose: bool = True) -> list[BenchmarkResult]:
    """Run the sweep; returns results and writes the reference-schema CSV."""
    impl = platform_label(None if mesh is None else mesh.devices.size)
    gens = {"random": generate_random_text,
            "repetitive": generate_repetitive_text}
    results = []
    for input_type in input_types:
        for size in sizes:
            for rep in range(reps):
                text = gens[input_type](size, seed=rep)
                r = run_benchmark(text, impl, input_type, mesh=mesh)
                results.append(r)
                if verbose:
                    print(f"{impl} {input_type} n={size} rep={rep}: "
                          f"total={r.total_time:.4f}s sa={r.sa_time:.4f}s")

    path = pathlib.Path(out_csv)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_HEADER)
        for r in results:
            w.writerow([r.implementation, r.input_type, r.string_length,
                        f"{r.total_time:.6f}", f"{r.sa_time:.6f}",
                        f"{r.lcp_time:.6f}", f"{r.lrs_time:.6f}",
                        r.memory_used, f"{r.compile_time:.6f}"])
    if verbose:
        print(f"Results saved to {path}")
    return results
