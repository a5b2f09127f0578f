import jax
import pytest

# NOTE: no XLA_FLAGS here on purpose — smoke tests and benches see ONE device;
# only launch/dryrun.py requests 512 fake devices (per its module header).

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with nvcc; skipped without one")
