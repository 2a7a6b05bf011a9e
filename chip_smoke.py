"""End-to-end smoke run of the suffix-array builder on NVIDIA GPUs.

    python chip_smoke.py            # one card: CLI, 1 GiB SA+LCP, families
    python chip_smoke.py --four     # four cards: --spawn 4 and the 4-way mesh

Every phase drives a user entry point (``sa-cli`` in-process, the
library builders, the sharded builders) at a real size and compares the
result byte for byte with the native SA-IS + Kasai oracle, which runs on
host threads beside the device work. Each phase prints one JSON line:
first-run seconds (compile included, not a metric), the builder path
taken, and the device's ``peak_bytes_in_use`` so far in the process. The
last line is ``{"ok": true, "device": {...}}``; any failed phase exits
nonzero before it. Without a GPU, or without the package beside this
script, it exits nonzero and prints no result.

One process per card: the one-card run keeps everything in this process
(the CLI runs through ``cli.main`` with stdout captured). ``--four`` runs
the ``--spawn 4`` launcher as a child while this process holds no card,
then opens all four cards in-process for the mesh phase.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import io
import json
import os
import pathlib
import re
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent

MiB = 1 << 20
GiB = 1 << 30
ONE_CARD_SIZES = dict(cli=64 * MiB, headline=GiB, family=256 * MiB,
                      doubling=MiB, lcp=256 * MiB)
FOUR_CARD_SIZES = dict(spawn=256 * MiB, mesh_big=GiB, mesh_small=16 * MiB)
DEVICE_PATHS = ("msd", "direct")


class SmokeError(RuntimeError):
    """A phase produced a wrong or unexpected result."""


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def require_gpu(devices) -> None:
    """Refuse anything but a GPU as the default device."""
    check(bool(devices) and devices[0].platform == "gpu",
          f"no GPU: JAX's default device is "
          f"{devices[0].platform if devices else 'none'!r}")


def nvidia_smi() -> str:
    """``name, power.limit`` of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip()


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def oracle(text: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(SA-IS suffix array, Kasai LCP) on the host."""
    from hpc_suffix_array_tpu import native

    sa = native.sa_build(text)
    return sa, native.lcp_kasai(text, sa)


def first_lrs(text: np.ndarray, sa: np.ndarray, lcp: np.ndarray) -> bytes:
    """The first-maximal repeated substring, as the library defines it."""
    j = int(np.argmax(lcp))
    return text[sa[j]:sa[j] + int(lcp[j])].tobytes()


def bench_text(n: int) -> np.ndarray:
    """The benchmark's seeded random-alnum corpus."""
    import bench

    return bench._bench_text(n)


def _exact(name: str, got, want: np.ndarray) -> None:
    got = np.asarray(got)
    check(got.shape == want.shape,
          f"{name}: shape {got.shape} != oracle {want.shape}")
    if not np.array_equal(got, want):
        bad = int(np.flatnonzero(got != want)[0])
        raise SmokeError(f"{name}: differs from the oracle at {bad} "
                         f"({got[bad]} != {want[bad]})")


def _structured(out: str, begin: str, end: str) -> dict:
    m = re.search(re.escape(begin) + r"\n(.*?)\n" + re.escape(end), out,
                  re.S)
    check(m is not None, f"no {begin} block in the CLI output")
    return dict(line.split(":", 1) for line in m.group(1).splitlines()
                if ":" in line)


def run_cli(argv: list[str]) -> str:
    """``sa-cli argv`` in this process; returns its stdout."""
    from hpc_suffix_array_tpu import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"sa-cli {argv} exited {rc}:\n{buf.getvalue()[-2000:]}")
    return buf.getvalue()


# ---------------------------------------------------------------- phases


def phase_cli(text: np.ndarray, ref, tmpdir: str) -> dict:
    """sa-cli on ``banana`` and on ``text`` written to a file; the
    IMPLEMENTATION it reports must name the default device's platform."""
    import jax

    platform = jax.devices()[0].platform
    out = run_cli(["banana"])
    check("Valid suffix array: YES" in out, "banana: not validated")
    check("Longest repeated substring: 'ana'" in out,
          "banana: LRS is not 'ana'")
    rec = _structured(out, "===STRUCTURED_RESULTS===", "===END_RESULTS===")
    check(rec.get("IMPLEMENTATION") == platform,
          f"banana: IMPLEMENTATION {rec.get('IMPLEMENTATION')!r}")

    path = os.path.join(tmpdir, "cli_corpus.txt")
    text.tofile(path)
    out = run_cli([path])
    check("Valid suffix array: YES" in out, "file: not validated")
    rec = _structured(out, "===STRUCTURED_RESULTS===", "===END_RESULTS===")
    check(rec.get("IMPLEMENTATION") == platform,
          f"file: IMPLEMENTATION {rec.get('IMPLEMENTATION')!r}")
    check(int(rec["FILE_SIZE"]) == text.size, "file: FILE_SIZE")
    check(rec.get("PATH") in DEVICE_PATHS, f"file: path {rec.get('PATH')!r}")
    sa, lcp = ref.result()
    want = first_lrs(text, sa, lcp)
    check(f"(length: {len(want)})" in out,
          f"file: LRS length is not the oracle's {len(want)}")
    return {"path": rec["PATH"], "n": text.size}


def phase_headline(text: np.ndarray, ref) -> dict:
    """build_sa_lcp against SA-IS + Kasai, the device validator and the
    oracle's LRS."""
    import jax

    from hpc_suffix_array_tpu.core.lcp import build_sa_lcp
    from hpc_suffix_array_tpu.core.lrs import find_longest_repeated_substring
    from hpc_suffix_array_tpu.core.validate import is_valid_suffix_array

    info: dict = {}
    sa, lcp = jax.block_until_ready(build_sa_lcp(text, info=info))
    check(info.get("path") in DEVICE_PATHS,
          f"headline: path {info.get('path')!r} is not a device path")
    check(sa.devices() == {jax.devices()[0]}, "headline: SA left the device")
    check(bool(is_valid_suffix_array(text, sa)),
          "headline: device validator rejected the SA")
    lrs = find_longest_repeated_substring(text, sa, lcp)
    want_sa, want_lcp = ref.result()
    _exact("headline SA", sa, want_sa)
    _exact("headline LCP", lcp, want_lcp)
    check(lrs == first_lrs(text, want_sa, want_lcp),
          "headline: LRS differs from the oracle's")
    return {"path": info["path"], "n": text.size}


# family -> (paths build_suffix_array may take, info key that must be set)
FAMILIES = {
    "dna": (DEVICE_PATHS, None),
    "period1000": (DEVICE_PATHS, "chain_mode"),
    "words": (DEVICE_PATHS, "refine_members"),
    "random_doubling": (("doubling",), None),
}


def family_text(name: str, n: int) -> np.ndarray:
    """Seeded corpus of one family (see FAMILIES)."""
    if name == "dna":
        from hpc_suffix_array_tpu.datasets.generate import generate_dna_text

        return generate_dna_text(n, seed=0xD0)
    if name == "period1000":
        return np.tile(bench_text(1000), -(-n // 1000))[:n]
    if name == "words":
        from hpc_suffix_array_tpu.utils.twin import twin_words

        return twin_words(n)[0]
    return bench_text(n)


def phase_family(name: str, text: np.ndarray, ref) -> dict:
    """build_suffix_array on one corpus family against SA-IS."""
    import jax

    from hpc_suffix_array_tpu.core.suffix_array import build_suffix_array

    paths, key = FAMILIES[name]
    info: dict = {}
    sa = jax.block_until_ready(build_suffix_array(text, info=info))
    check(info.get("path") in paths,
          f"{name}: path {info.get('path')!r}, want one of {paths}")
    check(sa.devices() == {jax.devices()[0]}, f"{name}: SA left the device")
    if key is not None:
        check(bool(info.get(key)), f"{name}: info[{key!r}] is "
              f"{info.get(key)!r}")
    _exact(f"{name} SA", sa, ref.result()[0])
    return {"path": info["path"], "n": text.size,
            **({key: info[key]} if key else {})}


def phase_lcp(text: np.ndarray, ref) -> dict:
    """Standalone build_lcp_array (given the oracle's SA) against Kasai."""
    import jax

    from hpc_suffix_array_tpu.core.lcp import build_lcp_array

    want_sa, want_lcp = ref.result()
    lcp = jax.block_until_ready(build_lcp_array(text, want_sa))
    _exact("standalone LCP", lcp, want_lcp)
    return {"path": "build_lcp_array", "n": text.size}


def phase_spawn(text: np.ndarray, ref, tmpdir: str, procs: int) -> dict:
    """``sa-cli FILE --spawn procs`` as a child: one card per worker. The
    root worker gathers the SA and checks it with the native validator
    (a valid suffix array is unique, so YES means it equals SA-IS)."""
    path = os.path.join(tmpdir, "spawn_corpus.txt")
    text.tofile(path)
    # Own process group, so a timeout also stops the launcher's workers.
    launcher = subprocess.Popen(
        [sys.executable, "-m", "hpc_suffix_array_tpu.cli", path,
         "--spawn", str(procs)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = launcher.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        os.killpg(launcher.pid, signal.SIGKILL)
        launcher.communicate()
        raise SmokeError(f"--spawn {procs} timed out")
    check(launcher.returncode == 0,
          f"--spawn {procs} exited {launcher.returncode}:\n{out[-2000:]}\n"
          f"{err[-4000:]}")
    check("Valid suffix array: YES" in out,
          "--spawn: the native validator rejected the gathered SA")
    rec = _structured(out, "--- STRUCTURED_RESULTS ---",
                      "--- END_STRUCTURED_RESULTS ---")
    check(int(rec["MPI_PROCESSES"]) == procs, "--spawn: MPI_PROCESSES")
    check(int(rec["ACTUAL_STRING_LENGTH"]) == text.size,
          "--spawn: string length")
    sa, lcp = ref.result()
    want = first_lrs(text, sa, lcp)
    check(f"Longest repeated substring: '{want.decode()}'" in out,
          "--spawn: LRS differs from the oracle's")
    return {"path": "sharded_msd_mp", "n": text.size, "processes": procs}


def validated_kasai(text: np.ndarray, sa: np.ndarray, pool) -> np.ndarray:
    """Kasai's LCP over ``sa`` once the native O(n) validator accepts it.

    A valid suffix array is unique, so acceptance means ``sa`` is the
    array SA-IS returns; the two checks run on two host threads. This
    replaces a full SA-IS run where host time is dear (four cards)."""
    from hpc_suffix_array_tpu import native

    valid = pool.submit(native.sa_validate, text, sa)
    lcp = pool.submit(native.lcp_kasai, text, sa)
    check(valid.result(), "the native validator rejected the SA")
    return lcp.result()


def phase_mesh(big: np.ndarray, small: np.ndarray, ref_small,
               n_devices: int, pool) -> dict:
    """Sharded builders over a 1-D mesh of ``n_devices`` devices: the
    one-pass MSD with LCP on ``big`` (checked by the native validator +
    Kasai); doubling and the sharded validator on ``small`` (checked
    against SA-IS)."""
    import jax

    from hpc_suffix_array_tpu.parallel import (
        build_suffix_array_sharded, build_suffix_array_sharded_big,
        is_valid_suffix_array_sharded, make_mesh)

    mesh = make_mesh(n_devices)
    sa, lcp = jax.block_until_ready(
        build_suffix_array_sharded_big(big, mesh, want_lcp=True))
    check(len(sa.sharding.device_set) == n_devices,
          "mesh: SA is not sharded over the mesh")
    sa_h = np.asarray(sa)[:big.size]
    lcp_h = np.asarray(lcp)[:big.size]
    del sa, lcp
    _exact("mesh LCP", lcp_h, validated_kasai(big, sa_h, pool))
    del sa_h, lcp_h
    sa2 = jax.block_until_ready(build_suffix_array_sharded(small, mesh))
    _exact("mesh doubling SA", np.asarray(sa2)[:small.size],
           ref_small.result()[0])
    check(bool(is_valid_suffix_array_sharded(small, sa2, mesh)),
          "mesh: sharded validator rejected the SA")
    return {"path": "sharded_msd", "n": big.size, "n_small": small.size,
            "devices": n_devices}


# ------------------------------------------------------------------ main


def _timed(name: str, fn, *args) -> dict:
    t0 = time.perf_counter()
    rec = fn(*args)
    rec = {"phase": name, "first_run_seconds": time.perf_counter() - t0,
           **rec, "peak_bytes_in_use": peak_bytes()}
    print(json.dumps(rec), flush=True)
    return rec


def run_one_card(pool, tmpdir: str) -> None:
    """Every corpus is made first and its oracle queued, largest first,
    so the host oracles overlap the device phases."""
    s = ONE_CARD_SIZES
    texts = {"headline": bench_text(s["headline"]),
             "cli": bench_text(s["cli"]),
             **{f: family_text(f, s["doubling" if f == "random_doubling"
                                    else "family"]) for f in FAMILIES},
             "lcp": bench_text(s["lcp"])}
    refs = {k: pool.submit(oracle, t) for k, t in texts.items()}
    _timed("cli", phase_cli, texts.pop("cli"), refs.pop("cli"), tmpdir)
    _timed("headline_sa_lcp", phase_headline, texts.pop("headline"),
           refs.pop("headline"))
    for f in FAMILIES:
        _timed(f"family_{f}", phase_family, f, texts.pop(f), refs.pop(f))
    _timed("standalone_lcp", phase_lcp, texts.pop("lcp"), refs.pop("lcp"))


def run_four_cards(pool, tmpdir: str, smi: str) -> None:
    """``--spawn 4`` first, while this process holds no card, then the
    in-process 4-way mesh."""
    s = FOUR_CARD_SIZES
    check(len(smi.splitlines()) >= 4, "--four needs four GPUs")
    texts = {k: bench_text(n) for k, n in s.items()}
    refs = {k: pool.submit(oracle, texts[k]) for k in ("spawn", "mesh_small")}
    t0 = time.perf_counter()
    rec = phase_spawn(texts["spawn"], refs["spawn"], tmpdir, 4)
    print(json.dumps({"phase": "spawn4", "first_run_seconds":
                      time.perf_counter() - t0, **rec}), flush=True)
    _device_phase()
    _timed("mesh4", phase_mesh, texts["mesh_big"], texts["mesh_small"],
           refs["mesh_small"], 4, pool)


def _device_phase() -> None:
    import jax

    from hpc_suffix_array_tpu.utils.runtime import enable_compile_cache

    devs = jax.devices()
    require_gpu(devs)
    cache = enable_compile_cache()
    print(json.dumps({"phase": "device", "device_kind": devs[0].device_kind,
                      "count": len(devs), "jax": jax.__version__,
                      "compile_cache": cache}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card phases")
    args = p.parse_args(argv)

    if not (REPO / "hpc_suffix_array_tpu").is_dir():
        print("chip_smoke: the hpc_suffix_array_tpu package is not beside "
              "this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from hpc_suffix_array_tpu import native

    try:
        smi = nvidia_smi()
    except (OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: nvidia-smi failed: {e}", file=sys.stderr)
        return 2
    if not native.available():
        print("chip_smoke: native SA-IS is unavailable (no C compiler)",
              file=sys.stderr)
        return 2

    pool = concurrent.futures.ThreadPoolExecutor(3)
    try:
        with tempfile.TemporaryDirectory() as tmpdir:
            if args.four:
                run_four_cards(pool, tmpdir, smi)
            else:
                _device_phase()
                run_one_card(pool, tmpdir)
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    import jax

    devs = jax.devices()
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
