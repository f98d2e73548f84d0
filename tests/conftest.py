import os

# Tests run on the single real CPU device (the dry-run spawns its own
# subprocesses with XLA_FLAGS; see test_dryrun_small.py). Keep device count
# at 1 here on purpose.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest

try:
    # CI profile for the property tests: jit/compile time on first examples
    # blows any wall-clock deadline, and the drawn JAX programs are
    # deterministic-per-example anyway -- disable the deadline and the
    # too-slow health check instead of flaking. No-op when hypothesis is
    # absent (the vendored tests/_hypothesis_stub.py has no deadlines).
    from hypothesis import HealthCheck, settings

    settings.register_profile(
        "repro-ci", deadline=None,
        suppress_health_check=[HealthCheck.too_slow])
    settings.load_profile("repro-ci")
except ImportError:
    pass


def pytest_configure(config):
    # registered here (no pytest.ini/pyproject [tool.pytest] section) so
    # `-W error` runs don't trip PytestUnknownMarkWarning
    config.addinivalue_line(
        "markers", "slow: long-running test (multi-device dry runs)")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card and nvcc (the port's kernels)")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
