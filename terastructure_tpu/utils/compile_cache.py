"""Persistent compilation cache location.

JAX keeps compiled programs across processes in the directory named by
`jax_compilation_cache_dir`. The directory is part of what a later run
must find again, so it is fixed: the `JAX_COMPILATION_CACHE_DIR`
environment variable when it is set (JAX reads it itself, and nothing is
set here), else `.jax_cache` at the root of the checkout.

Called by the entry points (cli.main, bench.py, chip_smoke.py), never at
import.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Use the fixed cache directory; returns the directory in use."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
