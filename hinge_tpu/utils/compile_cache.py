"""JAX's persistent compilation cache, in one fixed place.

Every `hinge <stage>` run is a fresh interpreter; without the cache each
one compiles the same device kernels again.  If JAX_COMPILATION_CACHE_DIR
is set, JAX already reads it and nothing here names another directory.
Otherwise the cache lives in `<checkout>/.jax_cache` (listed in
.gitignore).  The path is fixed on purpose: it is part of the cache key,
so a directory that moved between runs would never hit.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent cache on and return its directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = CHECKOUT_CACHE
        jax.config.update("jax_compilation_cache_dir", path)
    # cache every compile: the stages' many small kernels add up
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path
