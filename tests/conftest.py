"""Test configuration: an 8-device virtual CPU mesh.

Tests run on the CPU (``JAX_PLATFORMS=cpu``, the default here): multi-
device sharding is validated on XLA's host-platform device emulation,
per the rebuild test plan (SURVEY.md section 4), and the Pallas kernels
run in interpret mode. Tests marked ``gpu`` need the card; they skip
here and are run on the card by ``python chip_smoke.py`` (its card-tests
phase pins ``JAX_PLATFORMS=cuda``, which this module then leaves alone).
"""
import os

_pin = os.environ.get("JAX_PLATFORMS", "cpu")
if _pin == "cpu":
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import pytest  # noqa: E402

if _pin == "cpu":
    jax.config.update("jax_platforms", "cpu")
    # no persistent compilation cache for CPU test programs
    # (ptudes_tpu.compile_cache_dir explains why)
    jax.config.update("jax_compilation_cache_dir", None)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided per test, never
    at import or collection: every xdist worker collects the same
    tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs the card: run by `python chip_smoke.py`")


def pytest_addoption(parser):
    parser.addoption(
        "--full", action="store_true", default=False,
        help="also run tests marked slow (big shard_map compiles / long "
             "integrations). Default runs the fast tier so the suite is "
             "cheap enough to run before every commit; run --full before "
             "any release/snapshot.")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: big XLA:CPU compiles / long integration runs — "
                   "skipped unless --full (or -m slow) is given")
    config.addinivalue_line(
        "markers", "gpu: compiled kernels on the card — skip without one; "
                   "run by `python chip_smoke.py`")


def pytest_collection_modifyitems(session, config, items):
    # The 8-device shard_map programs (test_parallel) are the largest
    # XLA:CPU compiles in the suite. After ~100 tests' worth of
    # accumulated jit executables in one process, the CPU backend's
    # compiler can segfault on them (observed twice, always inside
    # backend_compile_and_load; the same tests pass in a fresh process).
    # Run them FIRST, while the process is clean — stable sort keeps the
    # usual order otherwise.
    items.sort(key=lambda it: 0 if "test_parallel" in it.nodeid else 1)
    # two-tier suite: the slow tier only runs with --full (or an explicit
    # -m slow selection)
    if not config.getoption("--full") and not config.getoption("-m"):
        skip = pytest.mark.skip(
            reason="slow tier: run with --full (pre-release) or -m slow")
        for it in items:
            if "slow" in it.keywords:
                it.add_marker(skip)


@pytest.fixture(autouse=True, scope="module")
def _free_executables_between_modules():
    # Drop jit executable references at module boundaries so the CPU
    # backend's compiled-program memory doesn't accumulate across the
    # whole suite (see pytest_collection_modifyitems above).
    yield
    jax.clear_caches()
