"""Test configuration.

Parity tests compare against the float64 NumPy/SciPy reference, so tests run
on CPU with x64 enabled.  An 8-device virtual CPU mesh is forced so the
multi-device (shard_map) paths are exercised without several GPUs, as
``__graft_entry__.dryrun_multichip`` does.  CPU is forced via ``jax.config``
before any backend is touched, so the tests never reach for a GPU even
where one is present (tests marked ``gpu`` start their own process).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(autouse=True, scope="module")
def _bounded_compile_state():
    """Clear jit executables at every module boundary.

    The XLA CPU compiler segfaults after ~100+ accumulated jit programs in
    one process (reproducible only in long full-suite runs, never in
    isolation — an upstream jit-state accumulation issue, not a flowsim
    defect). Clearing per module keeps the live-executable count bounded at
    the cost of some cross-module recompilation.
    """
    jax.clear_caches()
    yield


_TESTS_SINCE_CLEAR = [0]


@pytest.fixture(autouse=True)
def _bounded_compile_state_per_test():
    """Also clear every 8 tests WITHIN a module.

    Large parametrised modules can reach the same upstream crash threshold
    on their own; eight tests stay safely under it.
    """
    yield
    _TESTS_SINCE_CLEAR[0] += 1
    if _TESTS_SINCE_CLEAR[0] >= 8:
        _TESTS_SINCE_CLEAR[0] = 0
        jax.clear_caches()
