"""Persistent XLA compilation cache.

Every (core tier, length tier, batch tier) variant of the scan costs one
compile, so the CLI, the daemon and the scripts turn on JAX's persistent
compilation cache: a repeat scan of the same shapes skips compilation.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets nothing.  Otherwise the cache lives in ``.jax_cache`` at the
root of the checkout, a fixed path (the path is part of the cache key)
that git ignores.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    cache_dir = os.path.join(CHECKOUT, ".jax_cache")
    os.makedirs(cache_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    return cache_dir
