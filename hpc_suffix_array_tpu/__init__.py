"""Suffix-array / string-indexing framework for GPUs, in JAX.

A JAX/XLA implementation of the capabilities of the reference
C/MPI/CUDA project ``a-rtemis99/hpc_suffix_array`` (see SURVEY.md): Manber-Myers
prefix-doubling suffix-array construction with early termination, LCP array,
longest-repeated-substring extraction, self-validation, dataset generation,
CLI with structured machine-parseable output, and a benchmark harness.

Instead of the reference's three backends (sequential C, master-centric MPI,
absent CUDA - reference src/sequential/manber_myers.c:81-133,
src/mpi/manber_myers_mpi.c:22-161), this framework is a single sharded-array
program: the same jitted doubling driver runs on one chip or a multi-device
``jax.sharding.Mesh``, differing only in the mesh.
"""

from hpc_suffix_array_tpu.utils.hostmem import (
    disable_hugepage_madvise, keep_host_memory_hot)

# Host-memory workarounds from an earlier VM host (utils/hostmem.py), to
# be re-justified on the GPU host (ROADMAP D2).
disable_hugepage_madvise()
keep_host_memory_hot()

from hpc_suffix_array_tpu.core.suffix_array import (
    SuffixArray,
    build_suffix_array,
)
from hpc_suffix_array_tpu.core.lcp import build_lcp_array, build_sa_lcp
from hpc_suffix_array_tpu.core.lrs import find_longest_repeated_substring
from hpc_suffix_array_tpu.core.validate import is_valid_suffix_array
from hpc_suffix_array_tpu.parallel import (
    build_sa_lcp_sharded,
    build_suffix_array_sharded,
    make_mesh,
)

__version__ = "0.4.0"

__all__ = [
    "SuffixArray",
    "build_suffix_array",
    "build_suffix_array_sharded",
    "build_sa_lcp_sharded",
    "make_mesh",
    "build_lcp_array",
    "build_sa_lcp",
    "find_longest_repeated_substring",
    "is_valid_suffix_array",
    "__version__",
]
