"""Mesh-sweep corpus benchmark — the repo's `--oversubscribe` analog.

The reference's pipeline treats the MPI sweep as a first-class backend:
`mpirun --oversubscribe -np {2,4,8}` over the corpus files, with
speedup/efficiency columns joined against the sequential baseline and
rendered in the comparative chart's quadrants
(scripts/benchmark_mpi.py:61,154,203-210;
scripts/generate_comparative_charts.py:117-144). This sweep runs it on
the virtual CPU mesh — same shard_map programs, real XLA device
boundaries, all P devices sharing the host's physical cores exactly like
the reference's oversubscribed ranks shared one WSL2 box.

    python -m hpc_suffix_array_tpu.bench.mesh_sweep [sizes_mb ...]

Writes under results/benchmarks/:
  * sequential_results_cpu.csv — THIS RUN's single-device CPU baseline
    (the speedup denominator; sequential_results.csv is never touched);
  * parallel_results.csv — cpu_sharded_{2,4,8} rows with
    speedup/efficiency vs the same-run CPU baseline (every row carries
    a ``platform`` column so the provenance is explicit);
then regenerates the comparative chart + multi-backend report
(viz/charts.py), whose speedup/efficiency quadrants render from these
rows.

Honesty note (same as bench/weak_scaling.py): on a virtual mesh all P
devices share the host cores, so speedup ~ 1 and efficiency ~ 1/P even
for a perfectly-scaling program — these rows prove the *pipeline
contract* (sweep -> CSV schema -> charts -> report), and their RELATIVE
shape across corpora tracks algorithmic overhead; they are not hardware
scaling claims. The reference's oversubscribed numbers had the same
property on its single dev box.
"""

from __future__ import annotations

import sys

from hpc_suffix_array_tpu.bench.weak_scaling import _force_cpu_mesh

MB = 1 << 20


def main(sizes_mb=(1, 4), out_dir: str = "results/benchmarks",
         data_dir: str = "test_data", mesh_sizes=(None, 2, 4, 8)) -> None:
    _force_cpu_mesh(max(m for m in mesh_sizes if m) or 8)
    from hpc_suffix_array_tpu.utils.hostmem import release_host_memory

    release_host_memory()           # XLA:CPU churn vs the malloc pin

    import pathlib

    from hpc_suffix_array_tpu.bench.harness import benchmark_corpora
    from hpc_suffix_array_tpu.datasets.generate import (
        generate_dna_text, generate_random_text, generate_repetitive_text)
    from hpc_suffix_array_tpu.viz.charts import generate_comparative_charts
    from hpc_suffix_array_tpu.viz.report import generate_multi_backend_report

    data = pathlib.Path(data_dir)
    data.mkdir(parents=True, exist_ok=True)
    files = []
    gens = {"random": generate_random_text,
            "repetitive": generate_repetitive_text,
            "dna": generate_dna_text}
    for mb in sizes_mb:
        for fam, gen in gens.items():
            p = data / f"{fam}_{mb}MB.txt"
            if not p.exists():
                p.write_bytes(gen(mb * MB, seed=42).tobytes())
            files.append(p)

    benchmark_corpora(files, results_dir=out_dir,
                      mesh_sizes=tuple(mesh_sizes),
                      seq_csv_name="sequential_results_cpu.csv")
    generate_comparative_charts(out_dir)
    generate_multi_backend_report(out_dir)


if __name__ == "__main__":
    main(tuple(int(a) for a in sys.argv[1:]) or (1, 4))
