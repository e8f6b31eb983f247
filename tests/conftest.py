"""Suite-wide fixtures: fixed PRNG seed, slow marker for kernel sweeps."""
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: long-running kernel sweeps; deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA card (the port's hand-written kernels); skips "
        "without one -- run with -m gpu on a machine that has one")


@pytest.fixture(autouse=True)
def _fixed_global_seed():
    """Pin numpy's legacy global PRNG so tests that forget to pass a seeded
    Generator stay reproducible (jax keys and default_rng(seed) calls are
    already explicit everywhere)."""
    np.random.seed(0)
    yield
