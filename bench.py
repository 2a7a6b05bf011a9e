"""Headline benchmark: input bytes/sec/chip to full suffix array.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

``vs_baseline`` is the throughput ratio vs the repo's own native SA-IS
(hpc_suffix_array_tpu/native/sais.c, built from the tracked source), timed
in the same run on the same host and corpus family — the reference
publishes no numbers of its own (see BASELINE.md), so the baseline is
measured, not quoted.

Runs on JAX's default device; the CPU backend stays beside it for the
twin-corpus host mirror (utils/twin.py). A CPU default device is an error
unless ``JAX_PLATFORMS=cpu`` was set explicitly. Every JSON line names the
platform, device kind and device count.

Env knobs:
  SA_BENCH_BYTES      bench text size (default 1 GiB on an accelerator —
                      the BASELINE.md primary config — and 1 MiB on CPU)
  SA_BENCH_BASELINE_BYTES  native SA-IS baseline text size (default 16 MiB)
  SA_BENCH_REPS       timed repetitions (default 3, best-of)
"""

from __future__ import annotations

import json
import os
import pathlib
import sys
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent

sys.path.insert(0, str(REPO))
from hpc_suffix_array_tpu.utils.hostmem import (  # noqa: E402
    disable_hugepage_madvise, keep_host_memory_hot)

# Host workaround, to be re-justified on the GPU host (ROADMAP D2): see
# utils/hostmem.py.
disable_hugepage_madvise()
keep_host_memory_hot()


def _bench_text(n: int, out: np.ndarray | None = None) -> np.ndarray:
    """Random alnum corpus, the reference generator's main family
    (scripts/generate_large_datasets.py:12-14).

    Generated in 16 MiB chunks straight into one uint8 buffer: a single
    ``rng.integers(0, 62, n)`` call materializes an n x 8 B int64 temp
    (8.6 GB at the 1 GiB default) whose cold-page faults cost minutes on
    this VM class (utils/hostmem.py) — peak extra footprint here is one
    chunk. Deterministic for a given n (fixed seed + fixed chunking), so
    a shorter corpus is a prefix of a longer one.
    ``out`` lets the caller aim the bytes at a preallocated (e.g.
    padded staging) buffer and skip a second 1 GiB copy."""
    rng = np.random.default_rng(0xBEEF)
    alnum = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
        dtype=np.uint8)
    if out is None:
        out = np.empty(n, np.uint8)
    step = 1 << 24
    for i in range(0, n, step):
        m = min(step, n - i)
        out[i:i + m] = alnum[rng.integers(0, len(alnum), m).astype(np.uint8)]
    return out[:n] if out.shape[0] != n else out


def measure_device(n: int, reps: int) -> float:
    """Best-of-reps seconds for a full suffix-array build of n bytes.

    The corpus is twin-generated (utils/twin.py): born device-resident
    (a production index server keeps its corpus in device memory) with a
    bit-identical host mirror for the planning machinery. The timed
    region is the build itself, fenced by a device_get of the final
    element. Texts above SA_BIG_THRESHOLD use the out-of-core MSD path
    (core/bigsort.py) whose host-side planning — including the per-rep
    edge re-sampling — is part of the timed region; only corpus
    generation is excluded, same policy as the doubling path.
    """
    import jax
    import jax.numpy as jnp

    from hpc_suffix_array_tpu.core.suffix_array import (
        alphabet_remap, bucket_size, suffix_array_from_bytes_kernel)
    from hpc_suffix_array_tpu.utils.twin import twin_corpus

    if n > int(os.environ.get("SA_BIG_THRESHOLD", 1 << 22)):
        from hpc_suffix_array_tpu.core.bigsort import (
            chunk_geometry, estimate_repeat_len, execute_big,
            execute_direct, prefer_direct, prepare_big, prepare_direct,
            replan_edges)

        # Twin generation: the corpus is born on the device and mirrored
        # on the host by the same program on the CPU backend — nothing
        # crosses the host<->device link (utils/twin.py). Generated at
        # the largest geometry either route reads so the LIBRARY's own
        # routing gate (prefer_direct) picks the builder; a local copy
        # of the gate would drift from it.
        gen_pad = max(bucket_size(n), chunk_geometry(n)[2])
        text, text_dev = twin_corpus(n, gen_pad)
        remap, _, _ = alphabet_remap(text)
        est = estimate_repeat_len(text)
        if prefer_direct(text, n, est_repeat=est, sigma=int(remap.max())):
            dpad = bucket_size(n)
            dev = text_dev if gen_pad == dpad else text_dev[:dpad]
            state = prepare_direct(text, text_dev=dev, remap=remap,
                                   est_repeat=est)
            del dev
            sa = execute_direct(dict(state))      # warmup/compile
            jax.device_get(sa[-1])
            del sa
            best = float("inf")
            for _ in range(reps):
                t0 = time.perf_counter()
                sa = execute_direct(dict(state))
                jax.device_get(sa[-1])
                best = min(best, time.perf_counter() - t0)
                del sa
            info = {"path": "direct_sort"}
            if os.environ.get("SA_BENCH_LCP_BIG", "1") != "0":
                try:
                    _sa, lcp = execute_direct(dict(state),
                                              want_lcp=True)
                    jax.device_get(lcp[-1])
                    del _sa, lcp
                    t0 = time.perf_counter()
                    _sa, lcp = execute_direct(dict(state),
                                              want_lcp=True)
                    jax.device_get(lcp[-1])
                    info["sa_lcp_secs"] = time.perf_counter() - t0
                    del _sa, lcp
                except Exception as e:
                    print(f"# sa_lcp_build skipped: "
                          f"{type(e).__name__}: "
                          f"{str(e).splitlines()[0][:120]}",
                          file=sys.stderr)
            return best, info

        mpad = chunk_geometry(n)[2]
        if gen_pad != mpad:
            text_dev = text_dev[:mpad]
        state = prepare_big(text, text_dev=text_dev, remap=remap,
                            est_repeat=est)        # plan (untimed)
        # Re-plan BEFORE the warmup: the reps re-plan too, and the edge
        # sampler's bucket sizes pick the (static) slab/sort shapes — the
        # warmup must compile the same programs the timed reps run.
        replan_edges(state, text)
        sa = execute_big(dict(state))                  # warmup/compile
        jax.device_get(sa[-1])
        del sa
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            # Timed region includes the re-plan (edge re-sampling, on
            # device when the alphabet allows), the distribute passes,
            # and every bucket pass.
            replan_edges(state, text)
            sa = execute_big(dict(state))
            jax.device_get(sa[-1])
            best = min(best, time.perf_counter() - t0)
            del sa
        info = {"path": "msd_bigsort",
                "buckets": state["plan"].meta.get("n_buckets_run")}
        if state["plan"].meta.get("phase_host_s"):
            # Forensics: host-side stamps between the build's sync points
            # (scatter includes the re-plan; the bucket pass tail is
            # attributed by the caller's fence).
            print(json.dumps({
                "metric": "phase_split_headline",
                "unit": "s",
                **state["plan"].meta["phase_host_s"],
                "platform": jax.devices()[0].platform,
            }), file=sys.stderr)
        if state["plan"].meta.get("rerun"):
            # Honesty key: the build re-executed its passes at least once
            # (chain-direction misprediction or count-free capacity
            # overflow) — the timed number includes that re-run.
            info["rerun"] = state["plan"].meta["rerun"]
        if os.environ.get("SA_BENCH_LCP_BIG", "1") != "0":
            # Combined SA+LCP build at the same n (want_lcp derives the
            # LCP from the carried sort keys — the 1 GiB-class LCP
            # path). One warmup pays the lcp-variant compiles. Never
            # fatal: the SA headline above already succeeded, and a
            # failure here must not trip main()'s OOM-halving fallback.
            try:
                _sa, lcp = execute_big(dict(state), want_lcp=True)
                jax.device_get(lcp[-1])
                del _sa, lcp
                t0 = time.perf_counter()
                replan_edges(state, text)
                _sa, lcp = execute_big(dict(state), want_lcp=True)
                jax.device_get(lcp[-1])
                info["sa_lcp_secs"] = time.perf_counter() - t0
                del _sa, lcp
            except Exception as e:
                print(f"# sa_lcp_build skipped: {type(e).__name__}: "
                      f"{str(e).splitlines()[0][:120]}", file=sys.stderr)
        return best, info
    n_pad = bucket_size(n)
    text, text_pad = twin_corpus(n, n_pad)
    remap, bits, h0 = alphabet_remap(text)
    args = (text_pad, jnp.asarray(remap), bits, h0, jnp.int32(n))

    sa, _r, rounds = suffix_array_from_bytes_kernel(*args)   # warmup/compile
    jax.device_get(sa[-1])
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sa, _r, rounds = suffix_array_from_bytes_kernel(*args)
        jax.device_get(sa[-1])
        best = min(best, time.perf_counter() - t0)
        del sa     # free before the next rep (peak memory)
    return best, {"path": "doubling", "rounds": int(jax.device_get(rounds))}


def _is_oom(e: BaseException) -> bool:
    """Only genuine allocator exhaustion: the XLA status code, the
    allocator's canonical phrasing, or host MemoryError. A non-OOM
    failure that merely mentions memory must raise loudly, not silently
    shrink the headline n (r3 weak #5)."""
    msg = f"{type(e).__name__}: {e}"
    return (isinstance(e, MemoryError)
            or "RESOURCE_EXHAUSTED" in msg
            or "Out of memory" in msg
            or "out of memory" in msg)


def measure_native_baseline(n: int) -> float | None:
    """Bytes/sec of the native SA-IS build on n bytes of the bench corpus
    (best of 2), or None when no C compiler is available."""
    from hpc_suffix_array_tpu import native

    if not native.available():
        return None
    text = _bench_text(n)
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        native.sa_build(text)
        best = min(best, time.perf_counter() - t0)
    return n / best


def select_device():
    """The default device, with the CPU backend kept beside it.

    Exits nonzero when the default device is a CPU and
    ``JAX_PLATFORMS=cpu`` was not asked for explicitly: a benchmark that
    finds no accelerator must not report CPU numbers as device numbers."""
    import jax

    platforms = os.environ.get("JAX_PLATFORMS", "")
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")
    dev = jax.devices()[0]
    if dev.platform == "cpu" and platforms != "cpu":
        sys.exit("bench.py: no accelerator found (set JAX_PLATFORMS=cpu "
                 "to benchmark the CPU on purpose)")
    return dev


def main() -> None:
    import jax

    from hpc_suffix_array_tpu.utils.runtime import enable_compile_cache

    dev = select_device()
    enable_compile_cache()
    device = {"platform": dev.platform, "device_kind": dev.device_kind,
              "device_count": len(jax.devices())}

    # BASELINE.md's primary metric is bytes/sec/chip on 1 GiB text —
    # the default headline config (the carried-keys MSD path).
    # SA_BENCH_BYTES overrides.
    default_n = 1 << 30 if dev.platform != "cpu" else 1 << 20
    n = int(os.environ.get("SA_BENCH_BYTES", default_n))
    reps = int(os.environ.get("SA_BENCH_REPS", "3"))
    nb = int(os.environ.get("SA_BENCH_BASELINE_BYTES", 1 << 24))

    # Halve on OOM so the driver always gets a number; any fallback is
    # recorded in the output JSON (requested_bytes vs n). Non-memory
    # errors re-raise immediately — halving would bury a real bug under
    # 14 shrinking retries.
    requested_n = n
    while True:
        try:
            secs, info = measure_device(n, reps)
            break
        except Exception as e:
            if not _is_oom(e) or n <= 1 << 16:
                raise
            n //= 2
            msg = f"{type(e).__name__}: {e}"
            print(f"# falling back to {n} bytes ({msg.splitlines()[0][:120]})",
                  file=sys.stderr)
    bps = n / secs

    base_bps = measure_native_baseline(nb)
    vs = (bps / base_bps) if base_bps else 0.0

    # Secondary corpus classes on stderr (the driver consumes exactly one
    # stdout line). DNA stresses round count; periodic text is the
    # worst case (round count scales with log(period)).
    if info.get("sa_lcp_secs"):
        print(json.dumps({
            "metric": "sa_lcp_build",
            "value": round(n / info["sa_lcp_secs"] / 1e6, 3),
            "unit": "MB/s/chip",
            "n": n,
            "path": info.get("path", "") + "_want_lcp",
            **device,
        }), file=sys.stderr)
    if os.environ.get("SA_BENCH_SECONDARY", "1") != "0":
        try:
            import jax.numpy as jnp

            from hpc_suffix_array_tpu.core.suffix_array import (
                alphabet_remap, bucket_size, suffix_array_from_bytes_kernel)

            from hpc_suffix_array_tpu.core.bigsort import (
                chunk_geometry, direct_feasible, estimate_repeat_len,
                execute_big, execute_direct, prepare_big, prepare_direct)
            from hpc_suffix_array_tpu.utils.twin import (twin_corpus,
                                                         twin_periodic,
                                                         twin_words)

            def timed_best2(run):
                """Warmup + best-of-2 (one host stall must not poison
                the record); fence via device_get of the last element."""
                sa = run()
                jax.device_get(sa[-1])
                del sa
                dt = float("inf")
                for _ in range(2):
                    t0 = time.perf_counter()
                    sa = run()
                    jax.device_get(sa[-1])
                    dt = min(dt, time.perf_counter() - t0)
                    del sa
                return dt

            direct_max = int(os.environ.get("SA_DIRECT_MAX", 1 << 28))
            # Ladder sizes (BASELINE.md): DNA at the "256 MB DNA" config
            # (the third carried word makes it direct-feasible there);
            # periodic p1000 at the full headline size (chain mode
            # through the MSD machinery at 2^30 — r2 only measured 2^24).
            n_dna = min(n, 1 << 28)
            for tag, nsec, gen in (
                ("dna", n_dna,
                 lambda L: twin_corpus(n_dna, L, seed=0xD0,
                                       alphabet="dna")),
                ("repetitive_p1000", n,
                 lambda L: twin_periodic(_bench_text(1000), n, L)),
                # Zipfian word stream: the natural-text proxy whose
                # wide-shallow window-tie mass exercises the r5 device
                # refinement pass (core/refine.py) at full scale — the
                # corpus class the reference could build and r4 refused.
                ("words", n, lambda L: twin_words(n, L)),
            ):
                extra = {}
                if nsec <= (1 << 22):
                    # Small corpus (shrunken bench envs): doubling kernel.
                    arr, _ = gen(nsec)
                    n_pad = bucket_size(nsec)
                    host = np.zeros(n_pad, np.uint8)
                    host[:nsec] = arr
                    remap2, bits2, h02 = alphabet_remap(arr)
                    a = (jnp.asarray(host), jnp.asarray(remap2), bits2,
                         h02, jnp.int32(nsec))
                    dt = timed_best2(
                        lambda: suffix_array_from_bytes_kernel(*a)[0])
                    _sa, _r, rounds = suffix_array_from_bytes_kernel(*a)
                    extra["rounds"] = int(jax.device_get(rounds))
                    del _sa
                else:
                    # Production routing (prefer_direct): direct
                    # one-sort up to SA_DIRECT_CROSS or for chain-class
                    # text, else the fine-geometry MSD. The corpus
                    # family tells us chain-class up front (p1000 yes,
                    # DNA no) so the twin is generated at the right
                    # padded shape the first time.
                    cross = int(os.environ.get("SA_DIRECT_CROSS",
                                               1 << 27))
                    chainy = tag == "repetitive_p1000"
                    want_direct = (bucket_size(nsec) <= direct_max
                                   and (bucket_size(nsec) <= cross
                                        or chainy))
                    arr, dev = gen(bucket_size(nsec) if want_direct
                                   else chunk_geometry(nsec)[2])
                    if want_direct and direct_feasible(arr, nsec):
                        state = prepare_direct(arr, text_dev=dev)
                        dt = timed_best2(
                            lambda: execute_direct(dict(state)))
                        meta = state["meta"]
                        extra["path"] = ("direct_chain"
                                         if meta.get("chain_mode")
                                         else "direct_sort")
                        if state.get("nw", 2) != 2:
                            extra["carried_words"] = state["nw"]
                    else:
                        # dev was sized for the direct path if
                        # want_direct mispredicted feasibility; restage
                        # rather than hand prepare_big a wrong shape.
                        if tuple(dev.shape) != (chunk_geometry(nsec)[2],):
                            dev = None
                        state = prepare_big(arr, text_dev=dev)
                        dt = timed_best2(
                            lambda: execute_big(dict(state)))
                        meta = state["plan"].meta
                        extra["path"] = ("msd_chain"
                                         if meta.get("chain_mode")
                                         else "msd_bigsort")
                    if meta.get("rerun"):
                        extra["rerun"] = meta["rerun"]
                    for k in ("refine_members", "refine_rounds",
                              "refine_phase_s"):
                        if meta.get(k):
                            extra[k] = meta[k]
                    del dev, state
                print(json.dumps({
                    "metric": f"sa_build_{tag}",
                    "value": round(nsec / dt / 1e6, 3),
                    "unit": "MB/s/chip",
                    "n": nsec,
                    **extra,
                    **device,
                }), file=sys.stderr)

            # LCP throughput at benchmark scale (the reference's contract
            # always measures LCP_TIME, main_sequential.c:41-49).
            # `lcp_build` times build_lcp_array — the PRODUCTION routing
            # (> 8 MiB: carried-keys SA+LCP rebuild + sa cross-check,
            # core/lcp.py) — so the recorded number measures the path a
            # user's call actually takes. The standalone sorted-fetch
            # pass (core/lcp_window, the route production no longer
            # takes at this size) stays as the labeled alternative
            # `lcp_build_sorted_fetch`. Warmup reps pay the compiles.
            nl = min(n, 1 << 28)
            from hpc_suffix_array_tpu.core.lcp import build_lcp_array
            from hpc_suffix_array_tpu.core.lcp_window import (
                build_lcp_array_sorted, prepare_lcp_sorted)
            from hpc_suffix_array_tpu.utils.twin import twin_corpus

            # Pre-stage at the geometry the ROUTED build will use — a
            # mismatched dev would silently restage nl bytes INSIDE the
            # timed region. Generate once at the largest geometry any
            # route reads (zero-padded past nl, so shape views are
            # slices), then ask the LIBRARY's own gate which route runs.
            from hpc_suffix_array_tpu.core.bigsort import prefer_direct
            gen_pad = max(bucket_size(nl), chunk_geometry(nl)[2])
            arr, dev_l = twin_corpus(nl, gen_pad)
            route_pad = (bucket_size(nl) if prefer_direct(arr, nl)
                         else chunk_geometry(nl)[2])
            text_pad = (dev_l if gen_pad == bucket_size(nl)
                        else dev_l[:bucket_size(nl)])
            dev_route = (dev_l if gen_pad == route_pad
                         else dev_l[:route_pad])
            remap_l, bits_l, h0_l = alphabet_remap(arr)
            sa, _r, _rounds = suffix_array_from_bytes_kernel(
                text_pad, jnp.asarray(remap_l), bits_l, h0_l, jnp.int32(nl))
            jax.device_get(sa[-1])

            lcp = build_lcp_array(arr, sa, text_dev=dev_route)  # warmup
            jax.device_get(lcp[-1])
            del lcp
            dt = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                lcp = build_lcp_array(arr, sa, text_dev=dev_route)
                jax.device_get(lcp[-1])
                dt = min(dt, time.perf_counter() - t0)
                del lcp
            print(json.dumps({
                "metric": "lcp_build",
                "value": round(nl / dt / 1e6, 3),
                "unit": "MB/s/chip",
                "n": nl,
                "path": "build_lcp_array_routing",
                **device,
            }), file=sys.stderr)

            lstate = prepare_lcp_sorted(arr, text_pad_dev=text_pad)
            lcp = build_lcp_array_sorted(arr, sa, lstate)     # warmup
            jax.device_get(lcp[-1])
            del lcp
            dt = float("inf")
            for _ in range(2):
                t0 = time.perf_counter()
                lcp = build_lcp_array_sorted(arr, sa, lstate)
                jax.device_get(lcp[-1])
                dt = min(dt, time.perf_counter() - t0)
                del lcp
            print(json.dumps({
                "metric": "lcp_build_sorted_fetch",
                "value": round(nl / dt / 1e6, 3),
                "unit": "MB/s/chip",
                "n": nl,
                "path": "sorted_fetch_standalone",
                **device,
            }), file=sys.stderr)
        except Exception as e:
            print(f"# secondary metrics skipped: {e}", file=sys.stderr)

    line = {
        "metric": "suffix_array_build_throughput",
        "value": round(bps / 1e6, 3),
        "unit": "MB/s/chip",
        "vs_baseline": round(vs, 3),
        "n": n,
        "corpus": "random_alnum",
        "rounds": info.get("rounds", 0),
        **({"path": info["path"]} if info.get("path") != "doubling" else {}),
        **device,
    }
    if n != requested_n:
        line["requested_bytes"] = requested_n
        line["oom_fallback"] = True
    print(json.dumps(line))


if __name__ == "__main__":
    main()
