"""Persistent XLA compilation cache.

A BPTT training graph takes tens of seconds to compile; the persistent cache
makes that a once-per-machine cost for bench.py, chip_smoke.py and the
trainer, which all call ``enable_compilation_cache()`` before building any
jitted graph.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
module sets no other directory. Otherwise the cache lives at the fixed
``<repo>/.jax_cache``: the path is part of the cache key, so a directory that
moves never hits.
"""

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache everything, even fast compiles: the cost is disk, the win is
    # never re-paying a compile.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
