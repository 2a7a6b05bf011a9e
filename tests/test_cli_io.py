"""CLI, io, datasets, and bench-harness tests.

Models the reference's golden-output CLI tests (reference Makefile:119-138)
and the STRUCTURED_RESULTS parsing contract
(scripts/benchmark_sequential.py:13-72).
"""

import io
import json
import re

import numpy as np
import pytest

from hpc_suffix_array_tpu.cli import looks_like_file, main, run
from hpc_suffix_array_tpu.datasets.generate import (
    SMALL_FIXTURES, generate_dna_text, generate_random_text,
    generate_repetitive_text, generate_test_fixtures)
from hpc_suffix_array_tpu.utils.io import read_file, write_file


def test_file_heuristic():
    # reference main_sequential.c:65: '/' or '.' means file
    assert looks_like_file("test_data/banana.txt")
    assert looks_like_file("banana.txt")
    assert not looks_like_file("banana")
    assert not looks_like_file("mississippi")


def test_cli_string_golden(capsys):
    assert main(["banana"]) == 0
    out = capsys.readouterr().out
    assert "Longest repeated substring: 'ana' (length: 3)" in out
    assert "Valid suffix array: YES" in out
    # structured block parses with the reference harness regexes
    assert re.search(r"SA_TIME:([0-9.]+)", out)
    assert re.search(r"FILE_SIZE:6\b", out)
    assert "===STRUCTURED_RESULTS===" in out
    assert "===END_RESULTS===" in out


def test_cli_combined_sa_lcp_route(monkeypatch, capsys):
    """Above SA_LCP_BIG_MIN the CLI takes the one-pass combined SA+LCP
    build (carried-keys want_lcp) — results must match the default
    two-pass route, including validation and the LRS golden."""
    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")
    monkeypatch.setenv("SA_BIG_THRESHOLD", "10000")
    rng = np.random.default_rng(11)
    text = rng.integers(0, 62, 30_000).astype(np.uint8) + ord("0")
    block = text[:300].copy()
    text[15_000:15_300] = block         # a deep repeat for the LRS
    import io as _io

    buf = _io.StringIO()
    res = run(text, "synthetic", backend="single", n_devices=None,
              validate=True, dialect="sequential", out=buf)
    out = buf.getvalue()
    assert "Valid suffix array: YES" in out
    assert res["lrs_length"] >= 300


def test_cli_rerun_key(monkeypatch, capsys):
    """A build misprediction that re-executes the passes surfaces as a
    RERUN key in BOTH structured dialects (r3 weak #4): the CLI user of
    a mispredicted build sees that the reported time includes a re-run."""
    monkeypatch.setenv("SA_LCP_BIG_MIN", "10000")
    monkeypatch.setenv("SA_BIG_THRESHOLD", "10000")
    monkeypatch.setenv("SA_DIRECT_MAX", "4096")     # force the MSD route
    # Negative margin shrinks every count-free capacity below the true
    # fills: the overflow guard fires and the build re-runs exact.
    monkeypatch.setenv("SA_CF_MARGIN", "-0.5")
    rng = np.random.default_rng(5)
    text = rng.integers(0, 62, 30_000).astype(np.uint8) + ord("0")
    buf = io.StringIO()
    res = run(text, "synthetic", backend="single", n_devices=None,
              validate=True, dialect="both", out=buf)
    out = buf.getvalue()
    assert "Valid suffix array: YES" in out
    assert "count_free_overflow" in res.get("rerun", "")
    assert out.count("RERUN:count_free_overflow") == 2   # both dialects


def test_cli_file_and_mpi_dialect(tmp_path, capsys):
    p = tmp_path / "mississippi.txt"
    p.write_bytes(b"mississippi")
    assert main([str(p), "--dialect", "both"]) == 0
    out = capsys.readouterr().out
    assert "Longest repeated substring: 'issi' (length: 4)" in out
    assert "--- STRUCTURED_RESULTS ---" in out
    assert re.search(r"ACTUAL_STRING_LENGTH:11\b", out)
    assert re.search(r"MPI_PROCESSES:\d+", out)


def test_cli_sharded_backend(capsys):
    assert main(["abcabcabc", "--backend", "sharded", "--devices", "4"]) == 0
    out = capsys.readouterr().out
    assert "Longest repeated substring: 'abcabc' (length: 6)" in out
    assert re.search(r"PROCESSES:4\b", out)


def test_io_roundtrip(tmp_path):
    data = np.arange(256, dtype=np.uint8)
    p = tmp_path / "blob.bin"
    write_file(str(p), data)
    back = read_file(str(p), mmap=False)
    assert np.array_equal(np.asarray(back), data)
    mm = read_file(str(p), mmap=True)
    assert np.array_equal(np.asarray(mm), data)


def test_dataset_generators():
    r = generate_random_text(10_000, seed=1)
    assert len(r) == 10_000
    assert set(np.unique(r)) <= set(
        np.frombuffer(
            b"abcdefghijklmnopqrstuvwxyz"
            b"ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789", np.uint8).tolist())
    rep = generate_repetitive_text(5_000, seed=1, period=100)
    assert np.array_equal(rep[:100], rep[100:200])
    dna = generate_dna_text(1_000, seed=1)
    assert set(np.unique(dna)) <= set(b"ACGT")
    # deterministic per seed
    assert np.array_equal(r, generate_random_text(10_000, seed=1))


def test_fixture_generation_idempotent(tmp_path):
    first = generate_test_fixtures(tmp_path)
    assert sorted(p.name for p in first) == sorted(
        f"{k}.txt" for k in SMALL_FIXTURES)
    for p in first:
        meta = json.loads(
            p.with_suffix(p.suffix + ".meta").read_text())
        assert meta["length"] == len(SMALL_FIXTURES[p.stem])
    mtimes = {p: p.stat().st_mtime_ns for p in first}
    second = generate_test_fixtures(tmp_path)   # idempotent: no rewrite
    assert {p: p.stat().st_mtime_ns for p in second} == mtimes


def test_bench_micro_and_harness(tmp_path):
    import pandas as pd

    from hpc_suffix_array_tpu.bench import (
        benchmark_corpora, run_micro_benchmark)

    res = run_micro_benchmark(
        out_csv=tmp_path / "micro.csv", sizes=(1_000,), reps=1,
        input_types=("random",), verbose=False)
    assert len(res) == 1 and res[0].sa_time > 0
    df = pd.read_csv(tmp_path / "micro.csv")
    assert list(df.columns) == [
        "implementation", "input_type", "string_length", "total_time",
        "sa_time", "lcp_time", "lrs_time", "memory_used", "compile_time"]

    fixtures = generate_test_fixtures(tmp_path / "data")
    out = benchmark_corpora(
        fixtures[:2], results_dir=tmp_path / "results",
        mesh_sizes=(None, 2), verbose=False)
    assert (tmp_path / "results" / "sequential_results.csv").exists()
    par = pd.read_csv(tmp_path / "results" / "parallel_results.csv")
    assert {"speedup", "efficiency"} <= set(par.columns)
    assert (par["speedup"] > 0).all()   # the reference's silent-zero bug, fixed


def test_harness_failed_rows(tmp_path):
    """A poisoned file yields a FAILED row and the sweep continues
    (reference benchmark_sequential.py:105-130,211-213)."""
    from hpc_suffix_array_tpu.bench import benchmark_corpora

    good = tmp_path / "good.txt"
    good.write_bytes(b"mississippi" * 50)
    missing = tmp_path / "missing.txt"
    df = benchmark_corpora([missing, good], results_dir=tmp_path / "r",
                           verbose=False)
    assert len(df) == 2
    bad_row = df[df.file == "missing.txt"].iloc[0]
    assert not bad_row.success and "read error" in bad_row.error
    good_row = df[df.file == "good.txt"].iloc[0]
    assert good_row.success and good_row.sa_time > 0
    assert "compile_time" in df.columns


def test_weak_scaling_proxy(tmp_path):
    from hpc_suffix_array_tpu.bench.harness import weak_scaling_proxy

    df = weak_scaling_proxy(bytes_per_shard=2048, mesh_sizes=(1, 2),
                            results_dir=tmp_path / "r", verbose=False)
    assert len(df) == 2
    assert (df.scaling_mode == "weak_proxy_cpu_mesh").all()
    assert df.weak_efficiency.iloc[0] == 1.0
    assert (tmp_path / "r" / "parallel_results.csv").exists()

    # Pinned-builder sweeps: one algorithm per curve (the MSD threshold
    # env must be restored afterwards).
    import os
    df2 = weak_scaling_proxy(bytes_per_shard=2048, mesh_sizes=(1, 2),
                             results_dir=tmp_path / "r", builder="msd",
                             verbose=False)
    assert (df2.builder == "msd").all()
    assert df2.weak_efficiency.iloc[0] == 1.0
    assert "SA_SHARDED_MSD_MIN" not in os.environ


def test_structured_results_parser(capsys):
    from hpc_suffix_array_tpu.bench.parse import (
        parse_all_structured_results, parse_structured_results)

    assert main(["banana", "--dialect", "both"]) == 0
    out = capsys.readouterr().out
    rec = parse_structured_results(out)
    assert rec["dialect"] == "sequential"
    assert rec["file_size"] == 6
    assert rec["implementation"] == "cpu"
    assert rec["sa_time"] > 0
    both = parse_all_structured_results(out)
    assert len(both) == 2
    mpi = [r for r in both if r["dialect"] == "mpi"][0]
    assert mpi["actual_string_length"] == 6
    assert parse_structured_results("no block here") == {}


def test_run_benchmark_fused_route(monkeypatch):
    """Above SA_LCP_BIG_MIN the harness mirrors the CLI's fused
    carried-keys route: one build serves SA and LCP (the lcp phase is a
    fence, not a second full-text sort), and the outputs stay exact."""
    import numpy as np

    from hpc_suffix_array_tpu.bench.timing import run_benchmark

    monkeypatch.setenv("SA_LCP_BIG_MIN", "5000")
    monkeypatch.setenv("SA_BIG_THRESHOLD", "5000")
    rng = np.random.default_rng(3)
    text = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyz", np.uint8)[rng.integers(0, 26, 40_000)]
    r = run_benchmark(text, validate=True, warmup=False)
    assert r.valid is True
    assert r.sa_time > 0 and r.lcp_time >= 0
    # The fused route makes the lcp phase a fence: far below the sa
    # phase, where the old back-to-back form re-ran the whole build.
    assert r.lcp_time < r.sa_time


def test_cli_failure_emits_structured_failed_block(monkeypatch, capsys):
    """A build failure must produce an actionable error + a parseable
    FAILED block and exit nonzero, never a traceback (the reference CLI
    never crashes on a valid input, main_sequential.c:52-162; harnesses
    key off returncode + STRUCTURED_RESULTS)."""
    import hpc_suffix_array_tpu.core.suffix_array as sa_mod

    def boom(*a, **k):
        raise RuntimeError("RESOURCE_EXHAUSTED: injected for test")

    monkeypatch.setattr(sa_mod, "build_suffix_array", boom)
    rc = main(["banana"])
    assert rc == 1
    out = capsys.readouterr()
    assert "STATUS:FAILED" in out.out
    assert "ERROR:RuntimeError" in out.out
    assert "===STRUCTURED_RESULTS===" in out.out
    assert "build failed" in out.err
