"""Test configuration: the CPU platform with 4 virtual devices.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``).  Four virtual CPU
devices — the card count of the multi-GPU configuration — let the mesh
tests of test_sharding.py run in every pass.  Tests marked ``gpu`` take the
``gpu`` fixture, which skips them unless JAX's default backend is a GPU;
on the card run them with ``python -m pytest -m gpu tests/ -p no:xdist``.

A persistent compilation cache (utils/caches.py) makes repeated runs cheap.
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=4").strip()

# LLVM's JIT mmaps one region per compiled kernel section; with hundreds of
# kernels + persistent-cache loads a long pytest process exhausts the
# default vm.max_map_count (65530), which surfaces as "LLVM compilation
# error: Cannot allocate memory" followed by a SIGSEGV in the cache writer.
# Raise it when we can; harmless no-op otherwise.
try:
    with open("/proc/sys/vm/max_map_count", "r+") as _f:
        if int(_f.read()) < (1 << 21):
            _f.seek(0)
            _f.write(str(1 << 21))
except OSError:
    pass

import jax  # noqa: E402
import pytest  # noqa: E402

from jolt_tpu.utils.caches import enable_persistent_compilation_cache  # noqa: E402

enable_persistent_compilation_cache(jax)
# JOLT_TEST_NO_CACHE_WRITE=1: keep cache READS but write nothing — the
# jax 0.9.0 cache writer segfaults on certain executables (put_executable_
# and_time); run_tests.sh retries crashed files this way.
if os.environ.get("JOLT_TEST_NO_CACHE_WRITE"):
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test unless JAX runs on a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX default backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


@pytest.fixture
def mesh4():
    """A flat 4-device mesh; skips unless 4 devices exist."""
    if len(jax.devices()) < 4:
        pytest.skip(f"needs 4 devices, JAX sees {len(jax.devices())}")
    from jolt_tpu.parallel.sharding import make_mesh
    return make_mesh(4)
