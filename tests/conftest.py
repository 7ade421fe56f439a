import os
import sys
from pathlib import Path

# NOTE: do NOT set XLA_FLAGS device-count here — smoke tests and benches must
# see 1 device; only launch/dryrun.py forces 512 (and the sharding tests use
# a subprocess).
sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card, nvcc and the port's CUDA "
        "kernels; skipped where torch.cuda.is_available() is false")
