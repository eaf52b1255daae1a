"""JAX's persistent compilation cache, at one place per checkout.

JAX reads `JAX_COMPILATION_CACHE_DIR` itself; when that variable is set,
nothing here names another directory. Otherwise the cache lives in
`<checkout>/.jax_cache`, a fixed path (the path is part of what JAX keys
cached programs by, so a directory that moved would never hit).
"""

from __future__ import annotations

import os
from pathlib import Path

ENV = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=os.environ) -> str:
    """The directory the compilation cache uses under `environ`."""
    return environ.get(ENV) or str(CHECKOUT_CACHE)


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    import jax

    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir()
