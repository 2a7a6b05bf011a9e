"""Lazy-built native helpers (SA-IS, Kasai, validator) via ctypes.

Compiles ``sais.c`` to a shared object on first import (cached next to the
source, keyed by source hash). Any failure — no compiler, sandboxed FS —
degrades silently to ``available() == False`` and pure-Python fallbacks in
core/oracle.py, so the native layer never blocks the JAX path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "sais.c"
_lib = None
_tried = False
_lock = threading.Lock()


def _build() -> ctypes.CDLL | None:
    src = _SRC.read_text()
    tag = hashlib.sha256(src.encode()).hexdigest()[:16]
    so = _HERE / f"_native_{tag}.so"
    if not so.exists():
        cc = os.environ.get("CC", "cc")
        with tempfile.TemporaryDirectory() as td:
            tmp = pathlib.Path(td) / so.name
            subprocess.run(
                [cc, "-O3", "-shared", "-fPIC", str(_SRC), "-o", str(tmp)],
                check=True, capture_output=True, timeout=120)
            # atomic-ish move into the package dir
            tmp.replace(so)
        # drop stale builds
        for old in _HERE.glob("_native_*.so"):
            if old != so:
                try:
                    old.unlink()
                except OSError:
                    pass
    lib = ctypes.CDLL(str(so))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.native_sa_build.argtypes = [u8p, ctypes.c_int32, i32p]
    lib.native_sa_build.restype = ctypes.c_int
    lib.native_lcp_kasai.argtypes = [u8p, i32p, ctypes.c_int32, i32p]
    lib.native_lcp_kasai.restype = ctypes.c_int
    lib.native_sa_validate.argtypes = [u8p, i32p, ctypes.c_int32]
    lib.native_sa_validate.restype = ctypes.c_int
    return lib


def _get():
    global _lib, _tried
    with _lock:                 # first use may race from oracle threads
        if not _tried:
            _tried = True
            try:
                _lib = _build()
            except Exception:
                _lib = None
    return _lib


def available() -> bool:
    return _get() is not None


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _i32(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def sa_build(text) -> np.ndarray:
    """SA-IS suffix array (host, O(n)). Raises if native unavailable."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native helpers unavailable")
    arr = np.ascontiguousarray(np.asarray(text, np.uint8))
    n = int(arr.shape[0])
    sa = np.empty(n, np.int32)
    if n and lib.native_sa_build(_u8(arr), n, _i32(sa)) != 0:
        raise MemoryError("native_sa_build failed")
    return sa


def lcp_kasai(text, sa) -> np.ndarray:
    """Kasai LCP array (host, O(n)). Raises if native unavailable."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native helpers unavailable")
    arr = np.ascontiguousarray(np.asarray(text, np.uint8))
    sa = np.ascontiguousarray(np.asarray(sa, np.int32))
    n = int(arr.shape[0])
    lcp = np.zeros(n, np.int32)
    if n and lib.native_lcp_kasai(_u8(arr), _i32(sa), n, _i32(lcp)) != 0:
        raise MemoryError("native_lcp_kasai failed")
    return lcp


def sa_validate(text, sa) -> bool:
    """O(n) suffix-array validity check. Raises if native unavailable."""
    lib = _get()
    if lib is None:
        raise RuntimeError("native helpers unavailable")
    arr = np.ascontiguousarray(np.asarray(text, np.uint8))
    sa = np.ascontiguousarray(np.asarray(sa, np.int32))
    n = int(arr.shape[0])
    rc = lib.native_sa_validate(_u8(arr), _i32(sa), n)
    if rc < 0:
        raise MemoryError("native_sa_validate failed")
    return bool(rc)
