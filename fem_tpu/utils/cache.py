"""Where JAX's persistent compilation cache lives.

`JAX_COMPILATION_CACHE_DIR`, when set, names the directory and nothing
else is set. Otherwise the cache is `<checkout>/.jax_cache` (listed in
.gitignore): a fixed path, so later runs from the same checkout hit it.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        CHECKOUT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and return the directory."""
    import jax

    path = compile_cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
