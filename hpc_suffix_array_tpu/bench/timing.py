"""Per-phase benchmark timing: SA build / LCP build / LRS search.

Parity with the reference C benchmark core
(src/benchmark/suffix_array_benchmark.{h,c}): the ``BenchmarkResult``
record mirrors the struct at suffix_array_benchmark.h:9-18 and
``run_benchmark`` mirrors the phase protocol at :22-68 including the
3·n·sizeof(int32) working-set estimate (:61).

Differences from the C protocol:
  * every phase is fenced (device_get of the result tail) so
    device-async execution cannot leak across phase timers;
  * an untimed warmup run precedes the timed run, and the XLA compile
    cost is reported separately as ``compile_time`` (first run minus
    steady-state run). The reference's C timings had no JIT; folding
    compile into run time would make every small-n row garbage.

Phases are timed through ``utils.profiling.phase_timer`` so the CSV rows
and the CLI trace path share one timing mechanism.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np

from hpc_suffix_array_tpu.utils.profiling import PhaseTimings, phase_timer


@dataclass
class BenchmarkResult:
    """Mirror of the reference BenchmarkResult struct
    (suffix_array_benchmark.h:9-18) plus ``compile_time`` (JIT cost,
    separated so run-time rows stay comparable to the C baseline)."""

    implementation: str
    input_type: str
    string_length: int
    total_time: float
    sa_time: float
    lcp_time: float
    lrs_time: float
    memory_used: int
    lrs_length: int = 0
    valid: bool | None = None
    compile_time: float = 0.0
    # Which builder served the SA phase (direct/msd/doubling/sharded_*)
    # — speedup/efficiency pairs whose baseline ran a DIFFERENT builder
    # measure routing luck, not scaling, and are flagged downstream
    # (add_speedup_efficiency; r4 VERDICT weak #6).
    builder: str = ""

    def as_row(self) -> dict:
        return asdict(self)


def _strong_fence(x):
    """Completion fence: device_get of the last element of every array
    leaf. Host workaround, to be re-justified on the GPU host (ROADMAP
    D2); `block_until_ready` may be enough there."""
    import jax

    for leaf in jax.tree_util.tree_leaves(x):
        if hasattr(leaf, "shape") and getattr(leaf, "size", 0):
            jax.device_get(leaf.ravel()[-1])
        else:
            jax.block_until_ready(leaf)
    return x


def _pipeline(arr, mesh, timings: PhaseTimings | None, text_dev=None,
              info: dict | None = None):
    """One SA + LCP + LRS pipeline; phases timed into ``timings`` if given.

    ``text_dev``: optional device-resident copy of ``arr`` (zero-padded
    to the route's geometry) — forwarded to the single-device builders
    so the timed phases skip host->device staging (twin corpora)."""
    import contextlib

    from hpc_suffix_array_tpu.core.lcp import build_lcp_array
    from hpc_suffix_array_tpu.core.lrs import find_longest_repeated_substring
    from hpc_suffix_array_tpu.core.suffix_array import build_suffix_array

    def phase(name):
        if timings is None:
            return contextlib.nullcontext({})
        return phase_timer(timings, name, fence_fn=_strong_fence)

    # Mirror the CLI's production route (cli.py): above SA_LCP_BIG_MIN
    # one fused carried-keys pass yields SA and LCP together — timing
    # the standalone builders back to back would charge the full-text
    # sort twice, a cost no CLI user pays. The fused build lands in the
    # sa phase; the lcp phase is its fence (the reference equally
    # attributes per-phase time as the program actually runs,
    # main_sequential.c:97-117). bench.py's `lcp_build` metric still
    # measures the standalone build_lcp_array route separately.
    import os

    fused = None
    if mesh is None and int(arr.shape[0]) > int(
            os.environ.get("SA_LCP_BIG_MIN", 1 << 23)):
        from hpc_suffix_array_tpu.core.lcp import build_sa_lcp

        fused = build_sa_lcp
    elif mesh is not None and int(arr.shape[0]) >= int(
            os.environ.get("SA_SHARDED_MSD_MIN", 1 << 22)):
        # Sharded analog of the fused route (r5): one carried-keys pass
        # with want_lcp instead of SA-then-LCP separately.
        from hpc_suffix_array_tpu.parallel import build_sa_lcp_sharded

        def fused(a, text_dev=None, info=None):
            return build_sa_lcp_sharded(a, mesh, info=info)

    with phase("sa_build") as out:
        if fused is not None:
            sa, lcp = fused(arr, text_dev=text_dev, info=info)
        elif mesh is None:
            sa = build_suffix_array(arr, text_dev=text_dev, info=info)
        else:
            from hpc_suffix_array_tpu.parallel import build_suffix_array_sharded
            sa = build_suffix_array_sharded(arr, mesh, info=info)
        out["fence"] = sa
    if timings is None:
        _strong_fence(sa)

    with phase("lcp_build") as out:
        if fused is not None:
            pass                        # lcp already built above
        elif mesh is None:
            lcp = build_lcp_array(arr, sa, text_dev=text_dev)
        else:
            from hpc_suffix_array_tpu.parallel import build_lcp_array_sharded
            lcp = build_lcp_array_sharded(arr, sa, mesh)
        out["fence"] = lcp
    if timings is None:
        _strong_fence(lcp)

    with phase("lrs_search"):
        lrs = find_longest_repeated_substring(arr, sa, lcp)

    return sa, lcp, lrs


def run_benchmark(text, implementation: str = "",
                  input_type: str = "random", mesh=None,
                  validate: bool = False, warmup: bool = True,
                  text_dev=None) -> BenchmarkResult:
    """Time one full SA + LCP + LRS pipeline on ``text``.

    ``mesh=None`` uses the single-device kernel; otherwise the sharded
    builder over the given Mesh. ``implementation`` defaults to the
    platform label (``gpu``, ``cpu_sharded_8`` ...). ``warmup=True`` runs
    the pipeline once untimed first; the difference between the warmup
    and the timed run is reported as ``compile_time`` (0 when shapes were
    already cached).
    ``text_dev``: pre-staged device copy (see _pipeline).
    """
    import time

    from hpc_suffix_array_tpu.core.suffix_array import as_byte_array

    arr = as_byte_array(text)
    n = int(arr.shape[0])
    if not implementation:
        from hpc_suffix_array_tpu.utils.runtime import platform_label

        implementation = platform_label(
            None if mesh is None else mesh.devices.size)

    compile_time = 0.0
    if warmup:
        t0 = time.perf_counter()
        _pipeline(arr, mesh, None, text_dev)
        warmup_total = time.perf_counter() - t0

    info: dict = {}
    timings = PhaseTimings()
    with phase_timer(timings, "total", fence_fn=_strong_fence):
        sa, lcp, lrs = _pipeline(arr, mesh, timings, text_dev, info)

    if warmup:
        compile_time = max(0.0, warmup_total - timings["total"])

    valid = None
    if validate:
        from hpc_suffix_array_tpu.core.validate import is_valid_suffix_array
        valid = bool(is_valid_suffix_array(arr, sa))

    return BenchmarkResult(
        implementation=implementation,
        input_type=input_type,
        string_length=n,
        total_time=timings["total"],
        sa_time=timings["sa_build"],
        lcp_time=timings["lcp_build"],
        lrs_time=timings["lrs_search"],
        memory_used=3 * n * 4,   # reference estimate, suffix_array_benchmark.c:61
        lrs_length=len(lrs) if lrs else 0,
        valid=valid,
        compile_time=compile_time,
        builder=info.get("path", ""),
    )
