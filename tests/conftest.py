"""Test fixtures.  NOTE: XLA_FLAGS/device-count tricks are deliberately NOT
set here — smoke tests and benches must see the real single device; only
the dry-run (and subprocess-based distribution tests) force 512/8 devices.
"""

import numpy as np
import pytest

import _hypothesis_lite

# The container has no hypothesis wheel; fall back to the seeded-random
# shim (no-op when the real package is importable).
_hypothesis_lite.install()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Drop compiled-executable caches after each test module.

    A long single-process run accumulates hundreds of interpret-mode
    Pallas executables; on jaxlib 0.4.36 the XLA:CPU backend eventually
    segfaults inside ``backend_compile`` once enough JIT state has piled
    up (reproducible on the unmodified tree at ~1/3 of the suite).
    Bounding the live cache per module keeps the compiler healthy at the
    cost of some cross-module recompilation.
    """
    yield
    import jax

    jax.clear_caches()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where there is none")
