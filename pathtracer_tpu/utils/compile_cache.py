"""Where the persistent XLA compile cache lives.

First compiles of the fused kernels and of the BVH traversal take seconds
to minutes, so the package keeps JAX's persistent compilation cache on.
When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it; otherwise the cache goes to one fixed directory inside
the checkout (``.jax_cache/``, listed in ``.gitignore``).  A fixed path
matters: the path is part of the cache key, so a directory that moves
between runs never hits.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir(environ: Optional[Mapping[str, str]] = None) -> str:
    """The cache directory for the given environment (default: os.environ)."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or DEFAULT_DIR


def configure() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
