"""Persistent compilation cache shared by the library, the CLIs and the tests.

When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it.  Otherwise the cache lives at one fixed path inside the
checkout (``<repo>/.jax_cache``, listed in ``.gitignore``), so the next run
from the same checkout finds what this one compiled.
"""

from __future__ import annotations

import os
import pathlib

CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"

_DONE = False


def ensure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory (once per
    process) and return that directory."""
    global _DONE
    import jax

    if not _DONE:
        if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
            jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
        _DONE = True
    return jax.config.jax_compilation_cache_dir
