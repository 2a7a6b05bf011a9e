"""Tracing / profiling utilities.

The reference's observability is a pair of hand-rolled wall-clock helpers
(src/sequential/main_sequential.c:9-13 `get_time`, duplicated at
src/benchmark/suffix_array_benchmark.c:16-20, and `MPI_Wtime` in
src/mpi/main_mpi.c:40,63,70). The JAX equivalents:

  * ``phase_timer`` — wall-clock phase timing with an explicit
    `block_until_ready` fence so async device work can't leak across
    phase boundaries;
  * ``device_trace`` — a `jax.profiler` trace context producing a
    TensorBoard-loadable profile (XLA ops, fusion, device-memory
    traffic), the analog of the reference's ad-hoc nvprof usage
    (.gitignore:16).
"""

from __future__ import annotations

import contextlib
import time


class PhaseTimings(dict):
    """Phase-name -> seconds; insertion-ordered, printable."""

    def report(self) -> str:
        total = sum(self.values())
        lines = [f"  {k:24s} {v:10.6f} s  ({v / total:6.1%})"
                 for k, v in self.items()] if total else []
        return "\n".join(lines + [f"  {'total':24s} {total:10.6f} s"])


@contextlib.contextmanager
def phase_timer(timings: PhaseTimings, name: str, fence=None, fence_fn=None):
    """Time a phase; ``fence`` (any jax value/pytree) is fenced before the
    clock stops. The default fence is `jax.block_until_ready`; pass
    ``fence_fn`` for a stronger fence (e.g. a device_get-based one)."""
    import jax

    t0 = time.perf_counter()
    out = {}
    try:
        yield out
    finally:
        val = out.get("fence", fence)
        if val is not None:
            (fence_fn or jax.block_until_ready)(val)
        timings[name] = timings.get(name, 0.0) + time.perf_counter() - t0


@contextlib.contextmanager
def device_trace(log_dir: str):
    """jax.profiler trace context (view with TensorBoard's profile plugin)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
