"""Test harness config: CPU platform with 8 virtual devices + float64.

Runs the suite on the host CPU (SURVEY §4: "1 vs N shards must agree ...
testable on CPU via xla_force_host_platform_device_count") so tests are
hermetic and sharding tests get a virtual 8-device mesh.

Tests marked ``gpu`` need an NVIDIA card and skip elsewhere (the ``gpu``
fixture decides, at run time).  Run them on the card with the platform
named explicitly, which this harness then respects instead of pinning the
CPU:

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

_PLATFORM = os.environ.get("JAX_PLATFORMS") or "cpu"

if _PLATFORM == "cpu":
    # must be set before jax initializes any backend.  The
    # collective-timeout flags matter on slow/few-core CI hosts: the
    # XLA:CPU in-process rendezvous ABORTS the process if the 8 virtual
    # devices don't all reach a collective within 40 s, and on a 1-core VM
    # a concurrent XLA compile (e.g. materialize_u compiling while the
    # multi_step scan executes asynchronously) starves device threads past
    # that — observed as a deterministic suite abort in the heaviest
    # sharded test.  These are correctness tests, not perf tests: wait
    # long instead of dying.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
        + " --xla_cpu_collective_timeout_seconds=1200"
        + " --xla_cpu_collective_call_warn_stuck_timeout_seconds=300")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", _PLATFORM)
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first JAX device, which must be an NVIDIA GPU; skips otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (device 0 is {dev.platform}); "
                    "run: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return dev


# Persistent compile cache: repeated suite runs skip XLA compiles.  Set
# directly (not via enable_compile_cache, which refuses in this forced
# 8-virtual-device process — see its docstring) because warm caching is
# only unsafe for modules that run SHARDED programs: warm-loading sharded
# XLA:CPU executables can poison the in-process collective rendezvous for
# later scan-fused sharded programs (multi_step deadlocked 4/4 across two
# collective-permute op-ids, deterministically, whenever earlier sharded
# programs were cache-loaded; fresh compiles always pass).  The fixture
# below turns the cache off for exactly those modules.
from poroelasticity_dealii_tpu.utils.backend_quirks import (  # noqa: E402
    set_persistent_cache_dir)
from poroelasticity_dealii_tpu.utils.compile_cache import cache_dir  # noqa: E402


def _host_cache_tag() -> str:
    """Digest of this host's CPU features, used to segregate the test
    suite's XLA:CPU cache entries per machine.  XLA:CPU cache entries are
    AOT results that embed the *compile* machine's CPU feature set;
    loading them on a host with different features is explicitly
    unsupported (the loader warns "could lead to execution errors such as
    SIGILL") and was observed to corrupt execution after a VM migration:
    an 8-virtual-device collective-permute rendezvous split 4/4 across two
    op-ids and CHECK-failed (deterministic abort in
    test_production_multi_step_sharded_matches_sequential until the stale
    cache was bypassed).  Reads only /proc/cpuinfo."""
    import hashlib
    import platform

    txt = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    txt += " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    return hashlib.sha1(txt.encode()).hexdigest()[:12]


_CACHE_DIR = os.path.join(cache_dir(), "cpu-tests-" + _host_cache_tag())
jax.config.update("jax_compilation_cache_dir", _CACHE_DIR)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

# modules whose tests run collective (sharded) programs — directly via
# device meshes, or through deck-driven runners (psum/production decks in
# test_cli/test_amr/test_bucketing).  The poisoning needs warm-loaded
# sharded executables somewhere in the process, so every module that
# executes collectives stays cache-free; single-device modules keep the
# warm-suite speedup.
_SHARDED_MODULES = ("test_rows_sharding", "test_sharding",
                    "test_ghost_sharding", "test_parity_sharding",
                    "test_cli", "test_amr", "test_bucketing")


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache_for_sharded_modules(request):
    if request.module.__name__.split(".")[-1] not in _SHARDED_MODULES:
        yield
        return
    set_persistent_cache_dir(None)
    try:
        yield
    finally:
        set_persistent_cache_dir(_CACHE_DIR)


def _map_count():
    try:
        with open("/proc/self/maps", "rb") as fh:
            return sum(1 for _ in fh)
    except OSError:
        return -1


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module(request):
    """Release compiled executables between test modules.

    The suite compiles hundreds of distinct XLA programs; each loaded
    executable holds mmap'd code pages, and a single long pytest process
    eventually exhausts vm.max_map_count (default 65530) — observed as a
    segfault inside a *fresh* XLA compile near the end of the full suite,
    reproducible only with the preceding suite state and with modest RSS.
    Dropping jit caches per module lets executables be GC'd and unmapped;
    within-module reuse (the expensive repeated solver compiles) is kept.
    gc.collect() matters: executables sit in reference cycles (jitted
    closures <-> caches), so without an explicit collection the unmap can
    lag several modules behind the clear.  The per-module map count is
    appended to $POROEL_MAPLOG when set (suite-abort forensics).
    """
    yield
    jax.clear_caches()
    import gc
    gc.collect()
    log = os.environ.get("POROEL_MAPLOG")
    if log:
        with open(log, "a") as fh:
            fh.write(f"{_map_count()} {request.module.__name__}\n")
