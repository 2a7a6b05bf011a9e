"""Process-level runtime settings shared by every entry point.

  * ``compile_cache_dir`` / ``enable_compile_cache`` — where XLA's
    persistent compile cache lives. ``JAX_COMPILATION_CACHE_DIR`` wins
    when set; otherwise a fixed ``<checkout>/.jax_cache`` (gitignored).
    The path is part of the cache key, so it is never derived from a
    temporary name, a process id or the time.
  * ``platform_label`` — the honest implementation label for result rows
    and STRUCTURED_RESULTS (``gpu``, ``gpu_sharded_4``, ``cpu`` ...).
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def compile_cache_dir(environ=None) -> str:
    """``JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``."""
    environ = os.environ if environ is None else environ
    return (environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(CHECKOUT / ".jax_cache"))


def enable_compile_cache() -> str | None:
    """Point JAX's persistent compile cache at ``compile_cache_dir()``.

    Returns the directory in use, or None on the CPU backend: CPU runs
    (the test suite) compile fresh, because XLA:CPU cache entries are
    tied to the build host's machine features. Initializes the default
    backend, so call it after any platform selection."""
    import jax

    if jax.default_backend() == "cpu":
        return None
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


def platform_label(n_devices: int | None = None) -> str:
    """``<platform>`` or ``<platform>_sharded_<n_devices>`` of the default
    device (``unknown`` when no backend can start)."""
    import jax

    try:
        plat = jax.devices()[0].platform
    except RuntimeError:
        plat = "unknown"
    return plat if n_devices is None else f"{plat}_sharded_{n_devices}"
