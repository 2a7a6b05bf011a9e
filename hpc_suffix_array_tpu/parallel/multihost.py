"""Multi-host execution: process-group init + global mesh construction.

The reference's multi-node story is `mpirun -np P ./bin/main_mpi`
(scripts/benchmark_mpi.py:61) with OpenMPI as the process launcher and
communication backend. The JAX equivalent splits those roles:

  * process group: `jax.distributed.initialize()` — one Python process per
    host, coordinated through the JAX distributed service (the launcher is
    whatever starts the processes: GKE, xmanager, mpirun, ssh loops);
  * communication: XLA collectives (NCCL between GPUs: NVLink within a
    host, the network across hosts), generated from the same `shard_map`
    program that runs on one host — none of the framework's algorithm
    code changes.

With several processes each sees only its local devices;
`make_global_mesh()` builds the mesh over *all* devices and
`host_local_shard()` computes which block of the text this host should
feed into `jax.make_array_from_process_local_data`.

This module is exercised in single-process form by the test suite (a
process group of one), for 2 CPU processes by tests/test_multihost.py,
and for 4 processes with one GPU each by `chip_smoke.py --four`.
"""

from __future__ import annotations

import jax
import numpy as np

from hpc_suffix_array_tpu.parallel.mesh import make_mesh


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Initialize the cross-host process group (idempotent, single-process
    safe). Arguments default to the standard cluster-injected env vars."""
    if jax.process_count() > 1:
        return          # already initialized by the launcher
    if coordinator_address is None and num_processes is None:
        # single-process (tests, one host): nothing to initialize
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def make_global_mesh(n_devices: int | None = None):
    """Sequence-parallel mesh over every device in the job (all hosts)."""
    return make_mesh(n_devices=n_devices, devices=jax.devices())


def host_local_shard(n_pad: int, mesh) -> tuple[int, int]:
    """[start, stop) of the text block this host's devices own.

    Device d owns rows [d*m, (d+1)*m); a host's block is the union over
    its local devices (contiguous for the standard device order).
    """
    n_dev = int(mesh.devices.size)
    m = n_pad // n_dev
    local = [d for d in mesh.devices.flat if d.process_index == jax.process_index()]
    ids = sorted(np.flatnonzero(
        np.isin(mesh.devices.flatten(), local)))
    if not ids:
        return 0, 0
    return int(ids[0]) * m, (int(ids[-1]) + 1) * m


def put_sharded_text(text_pad: np.ndarray, mesh):
    """Create the global block-sharded array from per-host local data."""
    from hpc_suffix_array_tpu.parallel.mesh import sequence_sharding

    sharding = sequence_sharding(mesh)
    start, stop = host_local_shard(len(text_pad), mesh)
    return jax.make_array_from_process_local_data(
        sharding, np.asarray(text_pad[start:stop]), text_pad.shape)
