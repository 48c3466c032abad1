"""Process-wide JAX runtime settings shared by the entry points.

The CLI (`cli.main`), `bench.py` and `chip_smoke.py` call
`enable_compile_cache()` once, before their first compilation, so that a
second run of the same program on the same machine loads its executables
from disk instead of compiling them again.
"""

from __future__ import annotations

import os

# the checkout's own cache: a fixed path, because the cache key includes it
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def compile_cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when set, else `<checkout>/.jax_cache`."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and return that directory."""
    import jax
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
