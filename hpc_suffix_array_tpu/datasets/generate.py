"""Dataset generation: benchmark corpora + canonical test fixtures.

Parity with the reference generator (scripts/generate_large_datasets.py):
random alnum (:12-14), repetitive with a 1000-char base pattern (:16-23),
DNA ACGT (:25-28), the standard size ladder (:53-84), the small canonical
fixtures (:86-102), MD5 ``.meta`` sidecars (:30-51), and idempotent skips
(:64-66,71-72).

Difference: generation is vectorized numpy (chunked to bound host
RSS), not a Python string-concat loop — a 500 MB corpus generates in
seconds, and the arrays can feed `jax.device_put` directly.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import time

import numpy as np

ALNUM = np.frombuffer(
    b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
    dtype=np.uint8)
DNA = np.frombuffer(b"ACGT", dtype=np.uint8)

# Canonical strings (reference generate_large_datasets.py:86-102); their
# golden LRS values live in the reference Makefile:131-138.
SMALL_FIXTURES = {
    "banana": b"banana",
    "mississippi": b"mississippi",
    "abcabcabc": b"abcabcabc",
    "aaaa": b"a" * 1000,
    "ababab": b"ab" * 500,
}

MB = 1024 * 1024


def generate_random_text(n: int, seed: int = 0) -> np.ndarray:
    """Uniform random alnum bytes (reference :12-14)."""
    rng = np.random.default_rng(seed)
    return ALNUM[rng.integers(0, len(ALNUM), n)]


def generate_repetitive_text(n: int, seed: int = 0,
                             period: int = 1000) -> np.ndarray:
    """A random base pattern of ``period`` chars tiled to n (reference :16-23)."""
    base = generate_random_text(period, seed)
    return np.tile(base, -(-n // period))[:n]


def generate_dna_text(n: int, seed: int = 0) -> np.ndarray:
    """Uniform ACGT bytes (reference :25-28)."""
    rng = np.random.default_rng(seed)
    return DNA[rng.integers(0, 4, n)]


def generate_words_text(n: int, seed: int = 0, vocab_size: int = 1 << 14,
                        octaves: int | None = None) -> np.ndarray:
    """Zipfian dictionary-word stream — the natural-text proxy (r5).

    The reference's corpus families (random / repetitive / DNA) never
    exercise the tie structure a real index server sees: natural
    language, source code, and logs repeat short symbol windows at
    massive width but bounded depth.  This family models that with a
    space-separated stream of dictionary words drawn Zipf-like
    (P(word k) ~ 1/k): pick an OCTAVE uniformly, then a word uniformly
    within it — each octave carries equal total mass, the discrete
    analog of the 1/k law, using integer draws only (the same scheme
    utils/twin.twin_words runs on-device).  Word lengths 2-9 chars,
    alnum + space alphabet.  Fully vectorized assembly (no per-word
    Python loop): ~100 MB/s host generation.
    """
    rng = np.random.default_rng(seed)
    if octaves is None:
        octaves = max(1, int(vocab_size).bit_length() - 1)
    vocab_size = 1 << octaves
    lens = rng.integers(2, 10, vocab_size)          # word chars, 2..9
    lmax = 10                                       # + separator
    tab = np.zeros((vocab_size, lmax), np.uint8)
    for L in range(2, 10):
        rows = np.flatnonzero(lens == L)
        tab[rows[:, None], np.arange(L)[None, :]] = ALNUM[
            rng.integers(0, len(ALNUM), (len(rows), L))]
        tab[rows, L] = ord(" ")
    wl = (lens + 1).astype(np.int64)                # emitted cell length

    parts = []
    total = 0
    while total < n:
        k = max(1 << 14, (n - total) // 4)
        o = rng.integers(0, octaves, k)
        ids = (1 << o) + (rng.integers(0, 1 << 62, k) & ((1 << o) - 1))
        ids = np.minimum(ids, vocab_size - 1)
        L = wl[ids]
        ends = np.cumsum(L)
        starts = ends - L
        m = int(ends[-1])
        wid = np.repeat(ids, L)
        intra = np.arange(m, dtype=np.int64) - np.repeat(starts, L)
        parts.append(tab[wid, intra])
        total += m
    return np.concatenate(parts)[:n]


def _write_with_meta(path: pathlib.Path, data: np.ndarray,
                     kind: str) -> None:
    """Write corpus + MD5 .meta sidecar (reference :30-51), chunked."""
    md5 = hashlib.md5()
    with open(path, "wb") as f:
        for off in range(0, len(data), 64 * MB):
            chunk = bytes(data[off:off + 64 * MB])
            f.write(chunk)
            md5.update(chunk)
    meta = {
        "filename": path.name,
        "type": kind,
        "length": int(len(data)),
        "md5": md5.hexdigest(),
        "generated": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    path.with_suffix(path.suffix + ".meta").write_text(
        json.dumps(meta, indent=2))


def generate_test_fixtures(out_dir) -> list[pathlib.Path]:
    """Write the five canonical small fixtures (reference :86-102)."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for name, text in SMALL_FIXTURES.items():
        p = out / f"{name}.txt"
        if not p.exists():  # idempotent, reference :64-66
            _write_with_meta(p, np.frombuffer(text, np.uint8), "fixture")
        written.append(p)
    return written


def generate_standard_datasets(out_dir, random_mb=(1, 50, 100, 200, 500),
                               repetitive_mb=(1, 50, 100), dna_mb=(10,),
                               seed: int = 42) -> list[pathlib.Path]:
    """The reference's standard corpus ladder (reference :53-84), idempotent."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    plans = (
        [(f"random_{s}MB.txt", "random", generate_random_text, s)
         for s in random_mb]
        + [(f"repetitive_{s}MB.txt", "repetitive",
            generate_repetitive_text, s) for s in repetitive_mb]
        + [(f"dna_{s}MB.txt", "dna", generate_dna_text, s) for s in dna_mb]
    )
    for fname, kind, fn, size_mb in plans:
        p = out / fname
        if not p.exists():
            _write_with_meta(p, fn(size_mb * MB, seed), kind)
        written.append(p)
    return written
