"""Host-side byte I/O feeding device buffers.

Parity with the reference I/O utility library (src/common/utils.c:6-80):
whole-file binary read with size probe, file write, head/tail previews.
Difference: reads are zero-copy ``np.memmap`` views, so reading
a 1 GiB corpus costs no host RAM up front (the reference mallocs the whole
file, utils.c:25-36, then copies it again per rank over MPI_Bcast,
main_mpi.c:43-51). One padded host copy is still made later by
``build_suffix_array`` when it buckets the length for XLA shape reuse
(core/suffix_array.py) — the device transfer, not host RAM, is the
bottleneck on this link.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def read_file(path: str, mmap: bool = True) -> np.ndarray:
    """Read a file as uint8[n]. Memory-mapped (read-only view) by default."""
    size = os.path.getsize(path)
    if size == 0:
        return np.zeros((0,), np.uint8)
    if mmap:
        return np.memmap(path, dtype=np.uint8, mode="r", shape=(size,))
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype=np.uint8)


def write_file(path: str, data) -> None:
    """Write bytes/uint8 array to ``path`` (reference utils.c:50-59)."""
    arr = np.asarray(data, np.uint8) if not isinstance(data, (bytes, bytearray)) else data
    with open(path, "wb") as f:
        f.write(bytes(arr))


def _preview(data, n: int) -> str:
    b = bytes(np.asarray(data[:n], np.uint8)) if not isinstance(data, (bytes, bytearray)) else data[:n]
    return b.decode("utf-8", errors="replace")


def print_first_chars(data, n: int, file=None) -> None:
    """Head preview (reference utils.c:61-70)."""
    print(f"First {n} characters: {_preview(data, n)}", file=file or sys.stdout)


def print_last_chars(data, n: int, file=None) -> None:
    """Tail preview (reference utils.c:72-80)."""
    tail = data[-n:] if len(data) > n else data
    b = bytes(np.asarray(tail, np.uint8)) if not isinstance(tail, (bytes, bytearray)) else tail
    print(f"Last {n} characters: {b.decode('utf-8', errors='replace')}",
          file=file or sys.stdout)
