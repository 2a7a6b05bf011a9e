"""Host-memory workarounds, to be re-justified on the GPU host (ROADMAP D2).

An earlier VM host (a snapshot-restored microVM) served
transparent-hugepage faults through a userspace pager ~60x slower per
byte than base 4 KiB faults, and NumPy madvises hugepages for every large
allocation by default on Linux, which turned every corpus generation /
staging buffer into minutes of kernel time there.

``NUMPY_MADVISE_HUGEPAGE=0`` fixes it when set before numpy is imported;
an entry point that runs after numpy's import uses numpy's runtime
setter instead. Idempotent, safe on any platform (falls back silently
when the private hook moves).
"""

from __future__ import annotations

# mallopt parameter numbers (glibc malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def keep_host_memory_hot() -> bool:
    """Stop glibc from returning freed memory to the kernel.

    On this VM class, memory handed back to the kernel is unbacked by
    the hypervisor (free-page reporting, boot param
    ``page_reporting_order=11``) and the next touch is a ~840 us/4 KiB
    cold fault served by the host pager (~13 MB/s; measured 2026-08-17,
    vs ~1.4-4 GB/s for pages the process kept). Allocation churn —
    numpy temporaries, XLA:CPU per-op buffers — therefore re-pays the
    cold-fault tax on every cycle unless freed pages stay in-process.

    Two glibc knobs fix it: M_TRIM_THRESHOLD=max keeps the heap top,
    and M_MMAP_THRESHOLD=max routes large allocations through the heap
    instead of per-allocation mmap/munmap (an munmap is an immediate
    kernel release no trim setting can prevent). RSS then plateaus at
    the peak working set and stays hot. No-op off glibc.

    Trade-off: when free-page reporting is off (page_reporting_order
    high) freed-to-kernel pages stay host-backed and realloc-after-free
    is cheap, so the pin mostly buys fragmentation; SA_HOSTMEM_PIN=0
    skips it for such runs."""
    import os

    if os.environ.get("SA_HOSTMEM_PIN", "1") == "0":
        return False
    import ctypes
    import ctypes.util

    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        ok1 = libc.mallopt(_M_TRIM_THRESHOLD, ctypes.c_int(2**31 - 1))
        ok2 = libc.mallopt(_M_MMAP_THRESHOLD, ctypes.c_int(2**31 - 1))
        return bool(ok1 and ok2)
    except Exception:
        return False


def release_host_memory() -> bool:
    """Undo keep_host_memory_hot (reset glibc trim/mmap thresholds).

    Long-running XLA:CPU executions allocate and free constantly with
    high size diversity; under the pin, fragmentation converts that
    churn into unbounded fresh RSS (measured: an 8-device 1M-char dryrun
    was OOM-killed at 130 GB). Call this before execution-heavy CPU work
    so freed buffers return to the kernel normally."""
    import ctypes
    import ctypes.util

    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        ok1 = libc.mallopt(_M_TRIM_THRESHOLD, ctypes.c_int(128 * 1024))
        ok2 = libc.mallopt(_M_MMAP_THRESHOLD, ctypes.c_int(128 * 1024))
        return bool(ok1 and ok2)
    except Exception:
        return False


def disable_hugepage_madvise() -> bool:
    """Stop numpy from madvising THP for big allocations (see module
    docstring). Returns True when the hook was found and called."""
    try:
        from numpy._core import multiarray as _ma     # numpy >= 2
    except ImportError:
        try:
            from numpy.core import multiarray as _ma  # numpy 1.x
        except ImportError:
            return False
    setter = getattr(_ma, "_set_madvise_hugepage", None)
    if setter is None:
        return False
    setter(False)
    return True
