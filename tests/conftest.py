"""Test config: run on CPU with 8 virtual devices so sharding tests
emulate a multi-device mesh, and enable x64 for reference-parity tests
(the reference is float64 numpy).

JAX_PLATFORMS defaults to cpu here; tests marked `gpu` run on a card
with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` and skip
elsewhere (each decides in a fixture, never at import)."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import sys  # noqa: E402
import pytest  # noqa: E402

REFERENCE_PATH = "/root/reference"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips (in a fixture) without one")


@pytest.fixture(scope="session")
def reference():
    """Import the reference vireoSNP package (numpy implementation) for
    numerical parity checks."""
    if REFERENCE_PATH not in sys.path:
        sys.path.insert(0, REFERENCE_PATH)
    import vireoSNP
    return vireoSNP


@pytest.fixture()
def small_data():
    """A small random sparse AD/DP pair with planted donor structure."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.RandomState(11)
    n_var, n_cell, n_donor = 60, 40, 3
    GT = rng.randint(0, 3, size=(n_var, n_donor))
    theta = np.array([0.02, 0.5, 0.98])
    donor = rng.randint(0, n_donor, size=n_cell)

    DP = (rng.rand(n_var, n_cell) < 0.25) * rng.poisson(
        3, size=(n_var, n_cell))
    p = theta[GT[:, donor]]
    AD = rng.binomial(DP.astype(int), p)
    return (sp.csc_matrix(AD.astype(float)), sp.csc_matrix(DP.astype(float)),
            donor)
