"""Workarounds for host-backend (XLA:CPU) quirks.

Accelerator code paths never need anything in this module; it exists so
CI-environment plumbing stays out of the solver hot files.
"""

from __future__ import annotations

import contextlib

import jax
from jax.experimental.compilation_cache.compilation_cache import reset_cache


def set_persistent_cache_dir(path):
    """Point the persistent compilation cache at ``path`` (None = off).

    Updating ``jax_compilation_cache_dir`` alone is not enough: JAX opens
    the cache once, on the first compile, and keeps using it whatever the
    option says later.  ``reset_cache`` makes the next compile re-read the
    option."""
    jax.config.update("jax_compilation_cache_dir", path)
    reset_cache()


@contextlib.contextmanager
def no_persistent_cache_for_cpu_collectives():
    """Bypass the persistent compilation cache while compiling a scan-fused
    multi-step program on a multi-device CPU backend.

    The XLA:CPU in-process communicator deadlocks when the ``multi_step``
    executable (lax.scan over a body with shard_map collective-permutes
    and nested while_loops) is LOADED from the persistent cache rather
    than freshly compiled: the 8 virtual devices split across two
    collective-permute op-ids inside one run and the rendezvous
    CHECK-fails after its 40 s timeout (observed deterministically in
    test_production_multi_step_sharded_matches_sequential; the same
    program compiled fresh passes, and every *single-step* sharded
    program — psum/ghost/gspmd/production — round-trips the cache fine,
    so the bypass is scoped to exactly this shape of program).  GPU
    collectives (NCCL) don't use the in-process rendezvous, so only the
    CPU backend is affected.  Switching the persistent cache does not
    invalidate live jit caches, so wrapping every call is cheap."""
    if jax.default_backend() != "cpu" or jax.device_count() == 1:
        yield
        return
    prev = jax.config.jax_compilation_cache_dir
    if not prev:
        yield
        return
    set_persistent_cache_dir(None)
    try:
        yield
    finally:
        set_persistent_cache_dir(prev)
