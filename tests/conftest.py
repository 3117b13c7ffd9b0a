# NOTE: do NOT set xla_force_host_platform_device_count here — smoke tests
# and benches must see the real single CPU device; only launch/dryrun.py
# (separate processes) uses 512 placeholder devices.
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips (inside the test) where there is none"
    )


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
