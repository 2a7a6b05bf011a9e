"""Distributed CLI: the mpirun-analog launcher + worker (r5, VERDICT #3).

Spawns REAL OS processes (jax.distributed coordinator, per-process
block feeds through build_suffix_array_sharded_big_mp) via the CLI's
--spawn launcher and checks the MPI-dialect STRUCTURED_RESULTS contract
the reference harness parses (scripts/benchmark_mpi.py:31-49).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest

from hpc_suffix_array_tpu.core.oracle import lcp_oracle, suffix_array_oracle


@pytest.mark.slow
def test_spawn_two_process_cli(tmp_path):
    rng = np.random.default_rng(3)
    text = np.concatenate([
        np.frombuffer(b"abcdef", np.uint8)[rng.integers(0, 6, 60_000)],
        np.tile(np.frombuffer(b"xy", np.uint8), 2_000),
    ])
    f = tmp_path / "corpus.txt"
    f.write_bytes(text.tobytes())

    out = subprocess.run(
        [sys.executable, "-m", "hpc_suffix_array_tpu.cli", str(f),
         "--spawn", "2"],
        capture_output=True, text=True, timeout=600,
        env={**os.environ, "SA_PLATFORM": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr

    # The reference harness's regex contract (benchmark_mpi.py:31-49).
    block = re.search(
        r"--- STRUCTURED_RESULTS ---\n(.*?)--- END_STRUCTURED_RESULTS ---",
        out.stdout, re.S)
    assert block, out.stdout
    kv = dict(line.split(":", 1) for line in
              block.group(1).strip().splitlines())
    assert int(kv["ACTUAL_STRING_LENGTH"]) == len(text)
    assert int(kv["MPI_PROCESSES"]) == 2
    assert float(kv["SA_TIME"]) > 0
    assert float(kv["TOTAL_TIME"]) >= float(kv["SA_TIME"])

    assert "Valid suffix array: YES" in out.stdout
    sa = suffix_array_oracle(text.tobytes())
    lcp = lcp_oracle(text.tobytes(), sa)
    want_len = int(np.max(lcp))
    m = re.search(r"\(length: (\d+)\)", out.stdout)
    assert m and int(m.group(1)) == want_len


@pytest.mark.slow
def test_distributed_missing_args_errors():
    out = subprocess.run(
        [sys.executable, "-m", "hpc_suffix_array_tpu.cli", "banana",
         "--distributed"],
        capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": "/root"})
    assert out.returncode == 2
    assert "SA_NUM_PROCESSES" in out.stderr
