"""Real multi-process multi-host test: 2 processes x 4 virtual devices.

The reference exercises its distributed path by actually spawning
processes (scripts/benchmark_mpi.py:59-90, mpirun --oversubscribe); this
is the JAX equivalent — two OS processes, a real
`jax.distributed` coordinator, per-host sharded data feed, byte-exact
output (see tests/multihost_worker.py for what each process does).
"""

import pathlib
import socket
import subprocess
import sys

import pytest

WORKER = pathlib.Path(__file__).parent / "multihost_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_build():
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=WORKER.parent.parent)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for i, (rc, out, err) in enumerate(outs):
        assert rc == 0, f"proc {i} rc={rc}\nstderr:\n{err[-2000:]}"
        assert f"MULTIHOST_OK proc={i}" in out, out
        assert f"MULTIHOST_MSD_OK proc={i}" in out, out
