import numpy as np
import pytest


def pytest_configure(config):
    # the fused pipeline donates its packet buffers; the CPU backend cannot
    # alias them into the output and warns once per compile (expected —
    # donation engages on accelerators only, see kernels/fused_pipeline.py)
    config.addinivalue_line(
        "filterwarnings",
        "ignore:Some donated buffers were not usable:UserWarning",
    )
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
