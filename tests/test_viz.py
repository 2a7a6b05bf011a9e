"""Chart + report generation tests on synthetic sweep CSVs.

The reference's chart scripts were unrunnable as committed (they read a
CSV no script writes, generate_performance_charts.py:271); these tests
pin ours to the CSVs the harness actually produces.
"""

import numpy as np
import pandas as pd
import pytest


@pytest.fixture()
def seq_csv(tmp_path):
    rng = np.random.default_rng(3)
    sizes = np.array([1 << 14, 1 << 16, 1 << 18, 1 << 20])
    sa = sizes * 2e-8 + rng.uniform(0, 1e-4, len(sizes))
    lcp = sizes * 1e-8
    lrs = np.full(len(sizes), 2e-4)
    df = pd.DataFrame({
        "file": [f"f{i}.txt" for i in range(len(sizes))],
        "size_bytes": sizes,
        "size_mb": sizes / (1 << 20),
        "backend": "gpu",
        "processes": 1,
        "time_seconds": sa + lcp + lrs,
        "throughput_mb_s": sizes / (1 << 20) / (sa + lcp + lrs),
        "throughput_chars_per_second": sizes / (sa + lcp + lrs),
        "lrs_length": 12,
        "total_time": sa + lcp + lrs,
        "sa_time": sa,
        "lcp_time": lcp,
        "lrs_time": lrs,
        "compile_time": 0.5,
        "success": True,
        "error": "",
    })
    p = tmp_path / "sequential_results.csv"
    df.to_csv(p, index=False)
    return p


def test_performance_charts(seq_csv, tmp_path):
    from hpc_suffix_array_tpu.viz import generate_performance_charts

    paths = generate_performance_charts(seq_csv, tmp_path / "charts")
    assert len(paths) == 1 and paths[0].exists()
    assert paths[0].stat().st_size > 1000


def test_phase_breakdown_chart(seq_csv, tmp_path):
    """Dedicated breakdown figure (reference
    generate_performance_charts.py:132-197) including the lrs_time
    column the quadrant chart doesn't show."""
    from hpc_suffix_array_tpu.viz import generate_phase_breakdown_chart

    paths = generate_phase_breakdown_chart(seq_csv, tmp_path / "charts")
    assert len(paths) == 1 and paths[0].exists()
    assert paths[0].name == "phase_breakdown.png"
    assert paths[0].stat().st_size > 1000


def test_phase_breakdown_skips_failed_rows(seq_csv, tmp_path):
    from hpc_suffix_array_tpu.viz import generate_phase_breakdown_chart

    df = pd.read_csv(seq_csv)
    df.loc[len(df)] = df.iloc[-1]
    df.loc[len(df) - 1, ["success", "sa_time"]] = [False, 0.0]
    df.to_csv(seq_csv, index=False)
    paths = generate_phase_breakdown_chart(seq_csv, tmp_path / "charts")
    assert len(paths) == 1


def test_statistics_report(seq_csv, tmp_path):
    from hpc_suffix_array_tpu.viz import generate_statistics_report

    out = generate_statistics_report(
        seq_csv, tmp_path / "stats.txt")
    text = out.read_text()
    assert "STATISTICS" in text and "exponent" in text
