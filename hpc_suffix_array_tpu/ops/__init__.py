"""Device-level compute ops: sorts, scans, shifts.

These are the data-parallel replacements for the reference's hot native
loops (LSD radix sort: reference src/sequential/manber_myers.c:15-48;
re-rank scan: manber_myers.c:101-110), built on XLA's sort HLO and scan
fusion.
"""

from hpc_suffix_array_tpu.ops.sort import sort_by_rank_pairs
from hpc_suffix_array_tpu.ops.shift import shifted_ranks
from hpc_suffix_array_tpu.ops.scan import (
    dense_ranks, rerank_sorted, route_to_positions)

__all__ = ["sort_by_rank_pairs", "shifted_ranks", "rerank_sorted",
           "dense_ranks", "route_to_positions"]
