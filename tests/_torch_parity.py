"""Shared helpers of the `test_torch_*` files: the card fixture and the
straddle rule for comparing pipelines whose feature columns agree only to
float32 rounding."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.convert import forest_from_numpy
from repro_torch.kernels.ref import straddled_flows

# non-straddled flows agree in probability to this (vote sums in another
# order differ by a few float32 ulps of values <= 1)
PROB_ATOL = 1e-6
# straddled flows may be at most this share of a batch
MAX_STRADDLED = 0.01


@pytest.fixture
def cuda():
    """The card, or a skip: decided inside the test, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks "
                    "on the H100")
    return torch.device("cuda")


def assert_straddle_parity(p_a, p_b, x_a, x_b, forest) -> int:
    """Hold two pipelines' (N, K) probabilities to the straddle rule, given
    the (N, F) feature columns each side computed; returns the number of
    straddled flows. Every other flow agrees to PROB_ATOL with the same
    argmax."""
    p_a, p_b = np.asarray(p_a), np.asarray(p_b)
    assert p_a.shape == p_b.shape
    s = straddled_flows(x_a, x_b, forest.feature, forest.threshold,
                        forest.depth)
    assert s.sum() <= MAX_STRADDLED * len(s), f"{s.sum()} straddled flows"
    keep = ~s
    np.testing.assert_allclose(p_b[keep], p_a[keep], rtol=0, atol=PROB_ATOL)
    np.testing.assert_array_equal(p_b[keep].argmax(1), p_a[keep].argmax(1))
    return int(s.sum())


def quantile_forest(x, rng, T=6, D=5, K=4):
    """A random depth-D forest over the (N, F) columns `x` whose thresholds
    are quantile edges of those columns, as the trainer's are: ties
    happen."""
    x = np.asarray(x)
    F = x.shape[1]
    feature = rng.integers(0, F, (T, 2 ** D - 1))
    q = rng.random((T, 2 ** D - 1))
    threshold = np.quantile(x, q.ravel(), axis=0, method="lower")[
        np.arange(q.size), feature.ravel()].reshape(T, -1)
    return forest_from_numpy(feature, threshold, rng.random((T, 2 ** D, K)),
                             D, F)
