import os

# tests run on the single real CPU device; dry-run owns the 512-device flag
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "subprocess: spawns fresh interpreter(s) with forced host devices "
        "(slow; CI runs these in a dedicated job via '-m subprocess' and "
        "keeps them out of the per-version matrix with '-m \"not "
        "subprocess\"')")
    config.addinivalue_line(
        "markers",
        "card: needs a CUDA card and skips without one; such files import "
        "no JAX and run on the card with '--noconftest'")


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.key(0)
