"""Placement of JAX's persistent compilation cache.

One rule for every entry point (CLI runner, AMR driver, bench): where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing here
touches the configuration; otherwise the cache lives at a fixed path
inside the checkout (``<checkout>/.jax_cache``, git-ignored), so repeated
runs of the same checkout find their earlier compiles.
"""

from __future__ import annotations

import os
import re

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(CHECKOUT, ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_CACHE_DIR


def enable_compile_cache():
    """Turn on the persistent compilation cache at :func:`cache_dir` (no-op
    if the environment or the caller already configured one).  Pays off
    across process runs of the same deck (restart = cache hit instead of a
    cold compile) and within adaptive runs, where shape bucketing
    (amr/bucketing.py) makes remeshes land on previously compiled shapes.

    Refuses outright in a forced virtual-multi-device CPU process
    (``--xla_force_host_platform_device_count=N>1``): warm-loading
    sharded executables there can poison the in-process collective
    rendezvous for later scan-fused sharded programs (observed: a freshly
    compiled ``multi_step`` deadlocked 4/4 across two collective-permute
    op-ids after earlier sharded programs in the same process were
    cache-loaded; see
    ``utils.backend_quirks.no_persistent_cache_for_cpu_collectives``).
    That mode only exists for sharding tests and rehearsals, where compile
    time is not the product concern."""
    m = re.search(r"xla_force_host_platform_device_count=(\d+)",
                  os.environ.get("XLA_FLAGS", ""))
    if m and int(m.group(1)) > 1:
        return
    import jax
    if jax.config.jax_compilation_cache_dir:
        return
    jax.config.update("jax_compilation_cache_dir", cache_dir())
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
