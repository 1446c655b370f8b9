"""Repo-local cache locations.

The XLA persistent compile cache is the directory JAX_COMPILATION_CACHE_DIR
names when that variable is set (JAX reads it itself; nothing here
overrides it), and ``<repo>/.cache/jit`` otherwise: a fixed path, so that
every process run from one checkout shares the same entries.  Generated
SRS tensors live under ``fixtures/srs`` (JOLT_TPU_SRS_CACHE_DIR overrides).
"""
from __future__ import annotations

import os

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def repo_root() -> str:
    return _REPO_ROOT


def jit_cache_dir() -> str:
    """XLA persistent compile cache (machine-specific binaries; gitignored)."""
    d = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".cache", "jit")
    os.makedirs(d, exist_ok=True)
    return d


def srs_cache_dir() -> str:
    """Generated-SRS point tensors, keyed (n, seed).  Committed to git for
    the test and bench SRS sizes — doubles as a frozen SRS fixture."""
    d = os.environ.get("JOLT_TPU_SRS_CACHE_DIR",
                       os.path.join(_REPO_ROOT, "fixtures", "srs"))
    os.makedirs(d, exist_ok=True)
    return d


def enable_persistent_compilation_cache(jax) -> str:
    """Turn on the persistent compile cache (idempotent); returns its
    directory.  With JAX_COMPILATION_CACHE_DIR set, JAX already uses it
    and no directory is set here."""
    d = jit_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d
