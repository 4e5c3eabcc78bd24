"""Test configuration: CPU backend with 8 virtual devices (multi-device
sharding tests run on a virtual mesh) and float64 enabled (parity config).

The platform is forced through ``jax.config`` (a site configuration may
have consumed the environment variables already); the XLA host-device-count
flag still applies because no backend has been initialized yet at conftest
import time.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


_SLOW_FILE = os.path.join(os.path.dirname(__file__), "slow_tests.txt")


def _slow_nodeids():
    """The measured slow tier (data-driven, not hand-curated): nodeids
    whose wall time pushed the full suite past the 10-minute push tier.
    Regenerate with scripts/update_slow_marks.py from a
    ``pytest --durations=0`` log after the suite's shape changes; tests
    not in the file (e.g. newly added ones) default to the fast tier."""
    try:
        with open(_SLOW_FILE) as f:
            return {ln.strip() for ln in f
                    if ln.strip() and not ln.startswith("#")}
    except FileNotFoundError:
        return set()


def pytest_collection_modifyitems(config, items):
    # XLA:CPU segfaults when compiling a large while_loop/shard_map graph
    # late in the run (after ~150 prior in-process compilations; the same
    # tests pass standalone — cumulative compiler/JIT state, not a test
    # bug). The tests are order-independent — compile the biggest graphs
    # first. Stable sort keeps the rest of the order unchanged.
    items.sort(key=lambda it: 0 if "test_spatial" in it.nodeid else 1)
    slow = _slow_nodeids()
    for it in items:
        if it.nodeid in slow:
            it.add_marker(pytest.mark.slow)


@pytest.fixture(scope="module", autouse=True)
def _reset_jax_compile_state():
    # second half of the workaround above: drop compiled executables (and
    # their JIT memory) between test modules so the in-process compiler
    # state never accumulates to the crash point
    yield
    jax.clear_caches()


_TEST_COUNT = {"n": 0}


def pytest_runtest_teardown(item, nextitem):
    # third half: the suite has grown past what per-module clears keep
    # under the crash threshold (measured: ~380-test runs segfault in a
    # late compile where 208-test runs passed) — also clear every 30
    # tests WITHIN a module, so no single large module accumulates to
    # the crash point either
    _TEST_COUNT["n"] += 1
    if _TEST_COUNT["n"] % 30 == 0:
        jax.clear_caches()


@pytest.fixture
def rng():
    return np.random.default_rng(0)
