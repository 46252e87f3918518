"""Shared fixtures.  NOTE: no XLA_FLAGS here — smoke tests and benches
must see the host's real (single) device; only the dry-run uses 512
placeholder devices (and only as a program entry point)."""
import jax
import pytest


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (skipped without one)")
