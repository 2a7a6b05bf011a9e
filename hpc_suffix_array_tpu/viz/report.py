"""Text statistics reports for benchmark runs.

Parity with the reference's txt reports: complexity classification
(scripts/generate_performance_charts.py:199-267) and the multi-backend
summary (scripts/generate_comparative_charts.py:152-189).
"""

from __future__ import annotations

import pathlib
import platform
from datetime import datetime

import numpy as np
import pandas as pd


def _classify_complexity(sizes: np.ndarray, times: np.ndarray) -> str:
    """Fit time ~ n^alpha; classify like the reference's 'complexity factor'
    (generate_performance_charts.py:199-267)."""
    if len(sizes) < 2:
        return "insufficient data"
    alpha = np.polyfit(np.log(sizes), np.log(np.maximum(times, 1e-12)), 1)[0]
    if alpha < 1.15:
        cls = "~linear O(n)"
    elif alpha < 1.35:
        cls = "~linearithmic O(n log n)"
    elif alpha < 2.2:
        cls = "~quadratic O(n^2)"
    else:
        cls = "super-quadratic"
    return f"{cls} (fitted exponent {alpha:.2f})"


def generate_statistics_report(results_csv, out_path="results/charts/"
                               "performance_statistics.txt") -> pathlib.Path:
    df = pd.read_csv(results_csv).sort_values("size_bytes")
    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        "SUFFIX ARRAY PERFORMANCE STATISTICS",
        "=" * 60,
        f"generated: {datetime.now():%Y-%m-%d %H:%M:%S}",
        f"platform:  {platform.platform()}",
        f"runs:      {len(df)}",
        "",
    ]
    if not df.empty:
        lines += [
            f"input sizes: {int(df.size_bytes.min())} .. "
            f"{int(df.size_bytes.max())} bytes",
            f"best throughput: {df.throughput_mb_s.max():.2f} MB/s",
            f"mean throughput: {df.throughput_mb_s.mean():.2f} MB/s",
            "complexity fit (SA build): " + _classify_complexity(
                df.size_bytes.to_numpy(float), df.sa_time.to_numpy(float)),
            "",
            "per-run detail:",
        ]
        for _, r in df.iterrows():
            lines.append(
                f"  {r['file'] if 'file' in r else r.get('backend', '?'):30s}"
                f" {int(r.size_bytes):>12d} B  sa={r.sa_time:.4f}s"
                f"  lcp={r.lcp_time:.4f}s  {r.throughput_mb_s:8.2f} MB/s")
    out.write_text("\n".join(lines) + "\n")
    return out


def generate_multi_backend_report(results_dir="results/benchmarks",
                                  out_path="results/charts/"
                                  "multi_backend_report.txt") -> pathlib.Path:
    rd = pathlib.Path(results_dir)
    frames = [pd.read_csv(p) for p in
              (rd / "sequential_results.csv",
               rd / "sequential_results_twin.csv",
               rd / "sequential_results_cpu.csv",
               rd / "parallel_results.csv")
              if p.exists()]
    out = pathlib.Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    lines = [
        "MULTI-BACKEND COMPARISON REPORT",
        "=" * 60,
        f"generated: {datetime.now():%Y-%m-%d %H:%M:%S}",
        "",
    ]
    if frames:
        df = pd.concat(frames, ignore_index=True)
        for backend, g in df.groupby("backend"):
            lines += [
                f"[{backend}]",
                f"  runs: {len(g)}",
                f"  mean throughput: {g.throughput_mb_s.mean():.2f} MB/s",
                f"  best throughput: {g.throughput_mb_s.max():.2f} MB/s",
            ]
            if "speedup" in g.columns and g.speedup.notna().any():
                lines += [
                    f"  mean speedup:    {g.speedup.mean():.2f}x",
                    f"  mean efficiency: {g.efficiency.mean():.2%}",
                ]
            lines.append("")
    else:
        lines.append("no results found")
    out.write_text("\n".join(lines) + "\n")
    return out
