"""Timing / tracing utilities.

The reference ships a print-based wall-clock timer
(reference: tinyknn/utils.py:34-41). Here ``block`` waits for async
dispatch so device timings are honest, and an optional
``jax.profiler`` trace wrapper covers the "real" tracing story.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from pathlib import Path

import jax


@contextmanager
def timer(verbose, text):
    """Wall-clock timer context manager; prints when ``verbose``."""
    if verbose:
        print(text)
        start = time.time()
    yield
    if verbose:
        print(f"Took {time.time() - start:.1f}s")


def block(tree):
    """Block until every array in a pytree is computed (for timing)."""
    return jax.block_until_ready(tree)


@contextmanager
def profile_trace(logdir=None):
    """jax.profiler trace scope; no-op when logdir is None."""
    if logdir is None:
        yield
        return
    with jax.profiler.trace(str(logdir)):
        yield


# <checkout>/.jax_cache: resolved from the package, not the working
# directory, because the cache path is part of what a later run must find
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache(min_compile_secs=1.0) -> str:
    """Persist XLA compilations to disk so repeat runs start hot.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX keeps its cache
    there and this leaves it; otherwise the cache is
    ``<checkout>/.jax_cache``. Returns the directory in use."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_secs))
    return jax.config.jax_compilation_cache_dir
