"""Test configuration.

Tests run on CPU with 8 virtual devices so sharding tests work without
an accelerator; this must be set before jax is first imported.  Tests
that need the GPU carry the ``gpu`` marker and its fixture skips them
here (``gpu_only`` below); chip_smoke.py runs the path on the card.
"""

import os

# JAX_PLATFORMS=cuda,cpu keeps the GPU for the ``gpu``-marked tests on
# the card (README); every other run is pinned to the CPU
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

# NO persistent compilation cache for the suite.  It was enabled in
# round 2 (the suite is compile-dominated), but with round 3's test
# volume the process reproducibly DIED inside the cache machinery —
# SIGABRT in backend.deserialize_executable on re-reads after cpp-cache
# eviction, and SIGSEGV in serialize on write — always in
# jax/_src/compilation_cache.py, three runs, three different entries.
# The native deframer was ruled out with an ASan-instrumented build
# (fuzz suite clean); the crashes are in jaxlib's XLA:CPU executable
# (de)serialization under heavy compile churn.  Correctness over
# speed: cold compiles cost ~2x wall time but never crash.

import asyncio  # noqa: E402
import inspect  # noqa: E402

# Keep suite timing deterministic: no background calibration threads
# racing the tests' own jax work (test_signal_quality covers the warm
# path explicitly).
from webaudio_modem.ops import fsk_demod as _fsk_demod  # noqa: E402

_fsk_demod.AUTO_WARM_QUALITY = False


@pytest.fixture
def gpu_only():
    """Skip unless JAX's default platform is the GPU.  Decided here, at
    test run time — never at import or collection, so every xdist
    worker collects the same tests."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card: see README)")


def pytest_pyfunc_call(pyfuncitem):
    """Run ``async def`` tests on a fresh event loop (no pytest-asyncio
    in this image)."""
    fn = pyfuncitem.obj
    if inspect.iscoroutinefunction(fn):
        kwargs = {name: pyfuncitem.funcargs[name]
                  for name in pyfuncitem._fixtureinfo.argnames}
        asyncio.run(fn(**kwargs))
        return True
    return None
