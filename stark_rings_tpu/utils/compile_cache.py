"""JAX's persistent compilation cache: one rule for every entry script.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory.  Otherwise the cache lives at
``<checkout>/.jax_cache`` (listed in ``.gitignore``): a fixed path, so a
second run of the same program hits the entries the first one wrote.
"""

from __future__ import annotations

import os
import pathlib

__all__ = ["compile_cache_dir", "enable_compile_cache"]

_CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(_CHECKOUT / ".jax_cache"))


def enable_compile_cache() -> str:
    """Turn the persistent cache on (every compiled program is kept,
    however quick its compile) and return its directory."""
    import jax

    cache_dir = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir
