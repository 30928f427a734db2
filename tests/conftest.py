"""Test configuration.

Tests run on the CPU with 8 virtual devices so the multi-device sharding
tests run without a multi-GPU host (the "multi-node without a cluster"
mechanism; see SURVEY.md section 4).  ``JAX_PLATFORMS`` picks another
platform when the caller sets it: ``JAX_PLATFORMS=cuda pytest -m gpu`` runs
the tests that need the card on it.  The persistent compilation cache is
off for the test process.
"""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

# Upstream XLA:CPU issue: compile passes recurse deeply on the large fused
# programs (the one-dispatch quadtree pyramid, batch lax.map bodies) and the
# process aborts inside backend_compile_and_load — but ONLY after many
# compilations in one process.  Running tests/test_quadtree.py in one pytest
# process aborted at ~the 12th compile with the default 8 MB stack; the same
# programs compile cleanly in a fresh process.  This rlimit raise is a
# test-rig workaround for the upstream compiler, not a program fork.
import resource

_soft, _hard = resource.getrlimit(resource.RLIMIT_STACK)
if _hard == resource.RLIM_INFINITY or _hard >= 512 << 20:
    resource.setrlimit(resource.RLIMIT_STACK, (512 << 20, _hard))

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)  # virtual multi-device mesh
jax.config.update("jax_enable_compilation_cache", False)

import numpy as np
import pytest

LENNA_PATH = "/root/reference/tests/input/lenna512x512.png"


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    One pytest process compiles hundreds of XLA:CPU programs; past a point
    the accumulated JIT state makes further compiles abort the process
    (observed as ``Fatal Python error: Aborted`` inside
    ``backend_compile_and_load`` at ~40% of the suite, position varying run
    to run — a resource limit, not any single test).  Dropping the caches at
    module boundaries keeps intra-module cache sharing (where nearly all
    reuse is) while bounding per-process JIT accumulation.
    """
    yield
    jax.clear_caches()


@pytest.fixture(scope="session")
def lenna_y():
    """Y plane of the 512x512 Lenna fixture (same as the reference tests)."""
    if not os.path.exists(LENNA_PATH):
        pytest.skip("lenna fixture not available")
    from fractencode_tpu.image import load_gray

    return load_gray(LENNA_PATH)


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)
