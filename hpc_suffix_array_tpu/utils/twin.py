"""Twin corpus generation: the same bytes on device and host, no transfer.

Host workaround, to be re-justified on the GPU host (ROADMAP D2):
synthetic benchmark corpora are generated where they are used instead of
staged from the host, which was slow on an earlier host. This module
runs ONE jitted generator program twice —
once with the key on the accelerator (the corpus is born in device memory) and
once with the key on the host CPU backend (the planning/validation copy)
— and the two arrays are bit-identical because jax.random's threefry and
every op around it are integer ops, deterministic across XLA backends
(verified per call with a wrapped-int32 checksum).

The generator is built from PRNG bits + elementwise arithmetic only (the
alnum mapping is two selects, not a table gather), in fixed-size chunks
so both backends compile exactly one small program each.

Corpus families: uniform random over the reference generator's
62-letter alnum alphabet (reference
scripts/generate_large_datasets.py:12-14) and its 4-letter DNA alphabet
(:25-28); ``twin_periodic`` covers the repetitive family (:16-23) by
tiling a pattern on both sides (no PRNG needed).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

GEN_CHUNK = 1 << 24             # elements per generator dispatch


@functools.partial(jax.jit, static_argnums=(4, 5))
def _gen_chunk(key, i, start, n, m: int, alphabet: str = "alnum"):
    """uint8[m] chunk covering positions [start, start+m).

    Positions >= n are 0 (the padded-text convention every consumer
    expects). idx -> byte is pure arithmetic (selects, no table gather):
    alnum: 0..25 -> 'a'..'z', 26..51 -> 'A'..'Z', 52..61 -> '0'..'9';
    dna: 0..3 -> 'ACGT' (reference generate_large_datasets.py:25-28).
    """
    if alphabet == "dna":
        idx = jax.random.randint(
            jax.random.fold_in(key, i), (m,), 0, 4, dtype=jnp.int32)
        val = jnp.where(idx == 0, 65, jnp.where(idx == 1, 67, jnp.where(
            idx == 2, 71, 84))).astype(jnp.uint8)
    else:
        idx = jax.random.randint(
            jax.random.fold_in(key, i), (m,), 0, 62, dtype=jnp.int32)
        val = jnp.where(idx < 26, 97 + idx,
                        jnp.where(idx < 52, 39 + idx,
                                  idx - 4)).astype(jnp.uint8)
    pos = start + lax.iota(jnp.int32, m)
    return jnp.where(pos < n, val, jnp.uint8(0))


@functools.partial(jax.jit, donate_argnums=(0,))
def _write(buf, piece, off):
    return lax.dynamic_update_slice(buf, piece, (off,))


@jax.jit
def _checksum(buf):
    """Wrapped-int32 byte sum (two's-complement wrap matches numpy)."""
    return jnp.sum(buf.astype(jnp.int32))


def twin_corpus(n: int, n_pad: int | None = None, *, seed: int = 0xBEEF,
                chunk: int = GEN_CHUNK, device=None,
                alphabet: str = "alnum") -> tuple[np.ndarray, jax.Array]:
    """(host uint8[n], device uint8[n_pad]) with identical first-n bytes.

    ``device`` picks where the device copy lives (default: the process
    default device). The host copy always materializes through the CPU
    backend; zero bytes cross the host<->device link either way. Raises
    if the two copies' checksums disagree (they cannot, unless a backend
    breaks integer determinism — fail loudly rather than benchmark a
    corpus the host-side planner cannot see).
    """
    if n_pad is None:
        n_pad = n
    if n_pad < n:
        raise ValueError("n_pad must be >= n")
    key = jax.random.PRNGKey(seed)
    cpu = jax.devices("cpu")[0]
    if device is None:
        device = jax.devices()[0]

    # Host copy: same program, key committed to the CPU backend.
    k_host = jax.device_put(key, cpu)
    host = np.empty(n, np.uint8)
    for c in range(-(-n // chunk)):
        start = c * chunk
        piece = _gen_chunk(k_host, c, jnp.int32(start), jnp.int32(n),
                           chunk, alphabet)
        take = min(chunk, n - start)
        host[start:start + take] = np.asarray(piece)[:take]

    if device.platform == "cpu":
        # Single-backend process (tests): build the padded copy on host,
        # one plain transfer (free on CPU).
        pad = np.zeros(n_pad, np.uint8)
        pad[:n] = host
        return host, jax.device_put(pad, device)

    # Device copy: identical chunks born on the accelerator, assembled
    # with donated dynamic_update_slice (aliased in place by XLA).
    k_dev = jax.device_put(key, device)
    n_pieces = -(-n_pad // chunk)
    buf = jax.device_put(jnp.zeros(n_pieces * chunk, jnp.uint8), device)
    for c in range(n_pieces):
        piece = _gen_chunk(k_dev, c, jnp.int32(c * chunk), jnp.int32(n),
                           chunk, alphabet)
        buf = _write(buf, piece, jnp.int32(c * chunk))
    if buf.shape[0] != n_pad:
        buf = buf[:n_pad]

    dev_sum = int(jax.device_get(_checksum(buf)))
    host_sum = int(np.sum(host, dtype=np.int32))
    if dev_sum != host_sum:
        raise RuntimeError(
            f"twin corpus checksum mismatch (device {dev_sum} != host "
            f"{host_sum}); backends disagree on integer PRNG output")
    return host, buf


WORD_CELL = 8                   # 7-char word + space per cell
WORD_OCTAVES = 14               # vocab = 2^14 words, Zipf-like by octave


@functools.partial(jax.jit, static_argnums=(4,))
def _gen_words_chunk(key, i, start, n, m: int, vocab_tab):
    """uint8[m] chunk of the Zipfian word stream (m % WORD_CELL == 0).

    Word ids are drawn with INTEGER ops only (uniform octave + uniform
    offset within it — equal mass per octave, the discrete 1/k law), so
    the device and host copies are bit-identical across backends like
    every other twin family.  Bytes come from one (2^14, 8) vocab-table
    gather per cell."""
    cells = m // WORD_CELL
    k1, k2 = jax.random.split(jax.random.fold_in(key, i))
    o = jax.random.randint(k1, (cells,), 0, WORD_OCTAVES, dtype=jnp.int32)
    r = jax.random.randint(k2, (cells,), 0, jnp.int32(1) << 30,
                           dtype=jnp.int32)
    ids = (jnp.int32(1) << o) + (r & ((jnp.int32(1) << o) - 1))
    val = vocab_tab[ids].reshape(m)
    pos = start + lax.iota(jnp.int32, m)
    return jnp.where(pos < n, val, jnp.uint8(0))


def words_vocab(seed: int = 0x60D) -> np.ndarray:
    """Deterministic (2^WORD_OCTAVES, WORD_CELL) vocab table:
    7 random alnum chars + a trailing space per word."""
    rng = np.random.default_rng(seed)
    alnum = np.frombuffer(
        b"abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789",
        dtype=np.uint8)
    tab = np.empty((1 << WORD_OCTAVES, WORD_CELL), np.uint8)
    tab[:, :7] = alnum[rng.integers(0, len(alnum),
                                    ((1 << WORD_OCTAVES), 7))]
    tab[:, 7] = ord(" ")
    return tab


def twin_words(n: int, n_pad: int | None = None, *, seed: int = 0x90D5,
               chunk: int = GEN_CHUNK,
               device=None) -> tuple[np.ndarray, jax.Array]:
    """(host uint8[n], device uint8[n_pad]): the Zipfian word corpus.

    The natural-text proxy family (datasets.generate_words_text
    documents the model) at benchmark sizes with zero bulk staging:
    fixed 8-byte cells (7-char word + space) let both copies assemble
    from one integer-PRNG + small-table-gather program per chunk.
    Checksum-verified identical, like twin_corpus."""
    if n_pad is None:
        n_pad = n
    if n_pad < n:
        raise ValueError("n_pad must be >= n")
    key = jax.random.PRNGKey(seed)
    cpu = jax.devices("cpu")[0]
    if device is None:
        device = jax.devices()[0]
    tab_host = words_vocab()

    k_host = jax.device_put(key, cpu)
    tab_h = jax.device_put(tab_host, cpu)
    host = np.empty(n, np.uint8)
    for c in range(-(-n // chunk)):
        start = c * chunk
        piece = _gen_words_chunk(k_host, c, jnp.int32(start), jnp.int32(n),
                                 chunk, tab_h)
        take = min(chunk, n - start)
        host[start:start + take] = np.asarray(piece)[:take]

    if device.platform == "cpu":
        pad = np.zeros(n_pad, np.uint8)
        pad[:n] = host
        return host, jax.device_put(pad, device)

    k_dev = jax.device_put(key, device)
    tab_d = jax.device_put(tab_host, device)
    n_pieces = -(-n_pad // chunk)
    buf = jax.device_put(jnp.zeros(n_pieces * chunk, jnp.uint8), device)
    for c in range(n_pieces):
        piece = _gen_words_chunk(k_dev, c, jnp.int32(c * chunk),
                                 jnp.int32(n), chunk, tab_d)
        buf = _write(buf, piece, jnp.int32(c * chunk))
    if buf.shape[0] != n_pad:
        buf = buf[:n_pad]

    dev_sum = int(jax.device_get(_checksum(buf)))
    host_sum = int(np.sum(host, dtype=np.int32))
    if dev_sum != host_sum:
        raise RuntimeError(
            f"twin words checksum mismatch (device {dev_sum} != host "
            f"{host_sum}); backends disagree on integer PRNG output")
    return host, buf


@functools.partial(jax.jit, static_argnums=(1,))
def _tile_pattern(pat, n_pad: int, n):
    """uint8[n_pad]: pat tiled to cover n positions, 0 past n."""
    reps = -(-n_pad // pat.shape[0]) + 1
    buf = jnp.tile(pat, reps)[:n_pad]
    pos = lax.iota(jnp.int32, n_pad)
    return jnp.where(pos < n, buf, jnp.uint8(0))


def twin_periodic(pattern: np.ndarray, n: int, n_pad: int | None = None,
                  *, device=None) -> tuple[np.ndarray, jax.Array]:
    """(host uint8[n], device uint8[n_pad]): ``pattern`` tiled to n.

    The repetitive corpus family (reference
    generate_large_datasets.py:16-23) at benchmark sizes without bulk
    staging: the device copy is one tile program over the (tiny) staged
    pattern; the host copy is np.tile. Identical by construction."""
    if n_pad is None:
        n_pad = n
    if n_pad < n:
        raise ValueError("n_pad must be >= n")
    pattern = np.asarray(pattern, np.uint8)
    host = np.tile(pattern, -(-n // len(pattern)))[:n]
    if device is None:
        device = jax.devices()[0]
    pat_d = jax.device_put(pattern, device)
    return host, _tile_pattern(pat_d, n_pad, jnp.int32(n))
