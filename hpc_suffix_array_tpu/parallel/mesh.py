"""Device-mesh construction and sharding helpers.

The reference's process topology is a flat `MPI_COMM_WORLD`
(src/mpi/main_mpi.c:15-18). The JAX analog is a 1-D
`jax.sharding.Mesh` over the sequence axis: the text, rank and suffix-index
arrays are block-sharded along `SEQ_AXIS`, which is literal sequence
parallelism — the thing the reference never achieves (it replicates the
full text and rank array on every rank, main_mpi.c:43-51,
manber_myers_mpi.c:85,136).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

SEQ_AXIS = "seq"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """Build a 1-D sequence-parallel mesh over ``n_devices`` devices.

    Defaults to all local devices. Device count must be a power of two
    (the compare-split sort network is a hypercube).
    """
    if devices is None:
        devices = jax.devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices & (n_devices - 1):
        raise ValueError(f"mesh size must be a power of two, got {n_devices}")
    if n_devices > len(devices):
        raise ValueError(
            f"requested {n_devices} devices but only {len(devices)} "
            f"available ({[d.platform for d in devices[:4]]}...)")
    return Mesh(np.asarray(devices[:n_devices]), (SEQ_AXIS,))


def sequence_sharding(mesh: Mesh) -> NamedSharding:
    """Block sharding of a 1-D array along the sequence axis."""
    return NamedSharding(mesh, PartitionSpec(SEQ_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
