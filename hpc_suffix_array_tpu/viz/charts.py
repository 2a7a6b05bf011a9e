"""Benchmark charting: performance and comparative analysis figures.

Parity targets:
  * scripts/generate_performance_charts.py:26-197 — 4-quadrant analysis
    (log-log time vs size, throughput, theoretical O(n log n) overlay
    :75-81, growth-factor bars :93-125) plus phase-breakdown charts;
  * scripts/generate_comparative_charts.py:43-150 — multi-backend
    time/throughput/speedup/efficiency quadrants.

Fixed vs the reference: reads the CSVs the harness actually writes (the
reference charts read results/benchmarks/large_scale/benchmark_results.csv,
a path no script produces — generate_performance_charts.py:271, SURVEY
§2.20), and no hard-coded author shebang path (:1).
"""

from __future__ import annotations

import pathlib

import numpy as np
import pandas as pd

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def _ensure(path) -> pathlib.Path:
    p = pathlib.Path(path)
    p.mkdir(parents=True, exist_ok=True)
    return p


def generate_performance_charts(results_csv, out_dir="results/charts"):
    """Single-backend 4-quadrant analysis + phase breakdown figure."""
    out = _ensure(out_dir)
    df = pd.read_csv(results_csv).sort_values("size_bytes")
    if df.empty:
        return []

    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    fig.suptitle("Suffix Array Performance Analysis")

    ax = axes[0, 0]
    ax.loglog(df.size_bytes, df.sa_time, "o-", label="measured SA build")
    n = df.size_bytes.to_numpy(float)
    # theoretical O(n log n) overlay anchored at the first point
    # (reference generate_performance_charts.py:75-81)
    theory = n * np.log2(np.maximum(n, 2))
    theory = theory / theory[0] * max(float(df.sa_time.iloc[0]), 1e-9)
    ax.loglog(n, theory, "--", label="O(n log n) (scaled)")
    ax.set_xlabel("input size (bytes)")
    ax.set_ylabel("SA build time (s)")
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)

    ax = axes[0, 1]
    ax.semilogx(df.size_bytes, df.throughput_mb_s, "s-")
    ax.set_xlabel("input size (bytes)")
    ax.set_ylabel("throughput (MB/s)")
    ax.grid(True, alpha=0.3)

    ax = axes[1, 0]
    if len(df) > 1:
        ratio_t = df.sa_time.to_numpy()[1:] / df.sa_time.to_numpy()[:-1]
        ratio_n = n[1:] / n[:-1]
        growth = ratio_t / ratio_n     # ~1 means linear scaling per size step
        labels = [f"{int(a)}→{int(b)}" for a, b in zip(n[:-1], n[1:])]
        ax.bar(range(len(growth)), growth)
        ax.set_xticks(range(len(growth)), labels, rotation=45, fontsize=7)
        ax.axhline(1.0, color="k", ls="--", alpha=0.5)
        ax.set_ylabel("growth factor (time ratio / size ratio)")
    ax.grid(True, alpha=0.3)

    ax = axes[1, 1]
    bottom = np.zeros(len(df))
    for phase in ("sa_time", "lcp_time"):
        if phase in df:
            ax.bar([str(int(x)) for x in n], df[phase], bottom=bottom,
                   label=phase)
            bottom = bottom + df[phase].to_numpy()
    ax.set_ylabel("time (s)")
    ax.set_xlabel("input size (bytes)")
    ax.tick_params(axis="x", rotation=45, labelsize=7)
    ax.legend()

    fig.tight_layout()
    path = out / "performance_analysis.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return [path]


def generate_phase_breakdown_chart(results_csv, out_dir="results/charts"):
    """Dedicated per-phase breakdown figure (absolute + relative).

    Parity with the reference's standalone breakdown figure
    (generate_performance_charts.py:132-197): left panel stacks absolute
    SA / LCP / LRS seconds per corpus size; right panel normalizes to
    100% so the Amdahl structure (which phase dominates where) is
    readable across 3 orders of magnitude of input size.
    """
    out = _ensure(out_dir)
    df = pd.read_csv(results_csv).sort_values("size_bytes")
    if "success" in df:
        df = df[df.success.astype(bool)]
    phases = [p for p in ("sa_time", "lcp_time", "lrs_time") if p in df]
    if df.empty or not phases:
        return []

    fig, (ax_abs, ax_rel) = plt.subplots(1, 2, figsize=(14, 5.5))
    fig.suptitle("Phase Breakdown: SA build / LCP build / LRS search")

    labels = [f"{b / (1 << 20):.2g}MB" if b >= 1 << 20 else str(int(b))
              for b in df.size_bytes]
    totals = sum(df[p].to_numpy(float) for p in phases)
    totals = np.maximum(totals, 1e-12)

    for ax, norm in ((ax_abs, None), (ax_rel, totals)):
        bottom = np.zeros(len(df))
        for phase in phases:
            vals = df[phase].to_numpy(float)
            if norm is not None:
                vals = 100.0 * vals / norm
            ax.bar(labels, vals, bottom=bottom,
                   label=phase.replace("_time", ""))
            bottom += vals
        ax.tick_params(axis="x", rotation=45, labelsize=7)
        ax.legend()
        ax.grid(True, axis="y", alpha=0.3)
    ax_abs.set_ylabel("time (s)")
    ax_rel.set_ylabel("share of total (%)")
    ax_rel.set_ylim(0, 100)

    fig.tight_layout()
    path = out / "phase_breakdown.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return [path]


def generate_comparative_charts(results_dir="results/benchmarks",
                                out_dir="results/charts"):
    """Multi-backend comparison: time, throughput, speedup, efficiency
    (reference generate_comparative_charts.py:43-150)."""
    out = _ensure(out_dir)
    rd = pathlib.Path(results_dir)
    frames = []
    # sequential_results_cpu.csv: the CPU-mesh sweep's own single-device
    # baseline (bench/mesh_sweep.py) — a separate backend line, never a
    # replacement for the device rows. _twin: the device-born corpus
    # sweep (backend label <platform>_twin) — the build without its
    # staging, next to the file rows.
    for name in ("sequential_results.csv", "sequential_results_twin.csv",
                 "sequential_results_cpu.csv", "parallel_results.csv"):
        p = rd / name
        if p.exists():
            frames.append(pd.read_csv(p))
    if not frames:
        return []
    df = pd.concat(frames, ignore_index=True).sort_values("size_bytes")

    fig, axes = plt.subplots(2, 2, figsize=(14, 10))
    fig.suptitle("Backend Comparison")

    for backend, g in df.groupby("backend"):
        axes[0, 0].loglog(g.size_bytes, g.sa_time, "o-", label=backend)
        axes[0, 1].semilogx(g.size_bytes, g.throughput_mb_s, "s-",
                            label=backend)
    axes[0, 0].set_xlabel("bytes")
    axes[0, 0].set_ylabel("SA time (s)")
    axes[0, 0].legend()
    axes[0, 1].set_xlabel("bytes")
    axes[0, 1].set_ylabel("MB/s")
    axes[0, 1].legend()

    par = df[df.backend.astype(str).str.contains("_sharded_")]
    if "builder_mismatch" in par.columns:
        # Pairs whose baseline ran a different builder measure routing
        # luck, not scaling (bench/harness.add_speedup_efficiency) —
        # they stay in the CSV, labeled, but never plot as efficiency.
        par = par[~par.builder_mismatch.astype(bool)]
    if "speedup" in par.columns and not par.empty:
        for backend, g in par.groupby("backend"):
            axes[1, 0].semilogx(g.size_bytes, g.speedup, "o-", label=backend)
            axes[1, 1].semilogx(g.size_bytes, g.efficiency, "o-",
                                label=backend)
        axes[1, 0].axhline(1.0, color="k", ls="--", alpha=0.5)
        axes[1, 0].set_ylabel("speedup vs single device")
        axes[1, 1].set_ylabel("parallel efficiency")
        axes[1, 1].set_ylim(0, 1.2)
        for ax in (axes[1, 0], axes[1, 1]):
            ax.set_xlabel("bytes")
            ax.legend()
            ax.grid(True, alpha=0.3)

    fig.tight_layout()
    path = out / "backend_comparison.png"
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return [path]
