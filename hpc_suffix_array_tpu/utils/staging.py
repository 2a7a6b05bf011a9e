"""Chunked host->device staging for large byte arrays.

Host workaround, to be re-justified on the GPU host (ROADMAP D2): an
earlier host's transfer client made several full-size copies of a large
array, and its fresh host pages were slow to fault in (utils/hostmem.py).
Staging in fixed-size chunks bounds the client's scratch to one chunk
(reused hot across iterations thanks to ``keep_host_memory_hot``),
writing each chunk into a device-resident buffer with a donated
dynamic_update_slice (no reads of the donated operand -> XLA aliases it
in place, no device-side copy).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

STAGE_CHUNK = 1 << 27          # 128 MiB per transfer


@functools.partial(jax.jit, donate_argnums=(0,))
def _stage_write(buf, chunk, off):
    return lax.dynamic_update_slice(buf, chunk, (off,))


@jax.jit
def _probe(buf):
    return buf[0]


def stage_to_device(host: np.ndarray, chunk: int = STAGE_CHUNK):
    """Device array with ``host``'s contents; bounded host scratch.

    Small arrays go through one plain transfer. Large ones stream in
    ``chunk``-sized pieces (one fixed shape -> one compile; the tail
    piece reads past ``len(host)`` into a zero pad so every dispatch
    reuses the same program).
    """
    n = host.shape[0]
    if n <= chunk:
        return jnp.asarray(host)
    n_pieces = -(-n // chunk)
    buf = jnp.zeros((n_pieces * chunk,), host.dtype)
    tail = np.zeros((chunk,), host.dtype)
    last = n - (n_pieces - 1) * chunk
    tail[:last] = host[n - last:]
    for i in range(n_pieces):
        piece = host[i * chunk:(i + 1) * chunk] if i < n_pieces - 1 else tail
        buf = _stage_write(buf, jnp.asarray(piece), jnp.int32(i * chunk))
        # Fence each chunk: async dispatch otherwise keeps every chunk's
        # client-side transfer buffers alive at once (measured: RSS 6 GB
        # staging 1 GiB), defeating the bounded-scratch point.
        jax.device_get(_probe(buf))
    return buf[:n] if buf.shape[0] != n else buf
