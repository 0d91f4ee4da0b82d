import numpy as np
import pytest

# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests and
# benches must see the real single device; only launch/dryrun.py fakes 512.

# Optional dev-only deps (requirements-dev.txt). Modules that need hypothesis
# guard themselves with ``pytest.importorskip("hypothesis")`` at import time so
# a container without dev requirements sees skips, not collection errors.


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-second fault-injection tests (subprocess SIGKILL harness)")
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU of compute capability 9.0 or above and "
        "nvcc; skipped elsewhere")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
