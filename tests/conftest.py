"""Shared test configuration.

Registers the ``ci`` hypothesis profile CI selects with
``--hypothesis-profile=ci``: derandomized (a fixed seed, so a red run
reproduces exactly), no per-example deadline (jit compiles inside
examples blow any wall-clock budget), and health checks relaxed for the
engine-level fuzz cases whose first example compiles XLA programs.
Guarded import: the suite must collect and run (property cases skip)
when hypothesis is not installed — see ``_hypothesis_fallback``.

Also clears jax's trace/executable caches between test modules: a full
single-process suite run accumulates hundreds of compiled XLA programs,
and on single-core CPU hosts the accumulated compiler state eventually
segfaults a late ``backend_compile`` (observed deterministically in
``test_serving_engine`` at ~85% of the suite). Modules share almost no
jitted shapes, so the only cost is a handful of recompiles.
"""

import jax
import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    yield
    jax.clear_caches()

try:
    from hypothesis import HealthCheck, settings

    settings.register_profile(
        "ci",
        derandomize=True,
        deadline=None,
        suppress_health_check=[
            HealthCheck.too_slow,
            HealthCheck.data_too_large,
        ],
    )
except ImportError:  # pragma: no cover - optional dev dep
    pass


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (skips without one; run on the GPU "
        "machine with -m gpu)",
    )
