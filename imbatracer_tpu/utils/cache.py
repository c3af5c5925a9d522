"""On-disk caches, kept inside the checkout.

`enable_compile_cache()` is called by every entry point (the CLI,
`chip_smoke.py`, `bench.py`, `tools/`, the tests): JAX's persistent
compilation cache goes where `JAX_COMPILATION_CACHE_DIR` says, or, when
that is unset, to `<checkout>/.jax_cache/`.  A fixed path matters: the
directory is part of the cache key, so a cache that moves never hits.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT = Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".jax_cache")


def enable_compile_cache() -> str:
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def accel_cache_dir() -> str:
    """Where file scenes keep their built BVH (io/bvh_cache.py)."""
    return str(CHECKOUT / "build" / "accel")
