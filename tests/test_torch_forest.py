"""Forest traversal (B1) against `repro.kernels`: on one and the same
feature matrix every flow agrees, ragged flow and tree counts included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forest import forest_apply_np, train_forest
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.tree_infer import forest_infer_kernel_call as j_kernel_call
from repro.kernels.tree_infer import pad_forest_blocks as j_pad

from _torch_parity import PROB_ATOL
from repro_torch.convert import forest_from_numpy, forest_tables
from repro_torch.kernels import ops, ref
from repro_torch.kernels.tree_infer import forest_infer_plain, pad_forest_blocks


def _check(got, *wants):
    got = np.asarray(got)
    for want in wants:
        want = np.asarray(want)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=PROB_ATOL)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


# the shapes of tests/test_kernels.py::test_forest_infer_sweep
@pytest.mark.parametrize("n,F,K,T,depth", [
    (200, 6, 3, 7, 4), (512, 12, 28, 16, 6), (100, 4, 2, 3, 5)])
def test_forest_infer_matches_reference_trained(n, F, K, T, depth):
    R = np.random.default_rng(n)
    X = R.standard_normal((n, F)).astype(np.float32)
    y = R.integers(0, K, n)
    f = train_forest(X, y, n_trees=T, max_depth=depth,
                     rng=np.random.default_rng(1))
    jargs = (jnp.asarray(X), jnp.asarray(f.feature), jnp.asarray(f.threshold),
             jnp.asarray(f.leaf), f.depth)
    tf = forest_from_numpy(f.feature, f.threshold, f.leaf, f.depth, F)
    targs = (torch.from_numpy(X), *forest_tables(tf, "cpu"), f.depth)
    got = ops.forest_infer(*targs, block_t=4)
    _check(got, jops.forest_infer(*jargs, block_n=128, block_t=4),
           jref.forest_infer_ref(*jargs), forest_apply_np(f, X))
    _check(ref.forest_infer_ref(*targs), jref.forest_infer_ref(*jargs))


# the shapes of tests/test_fused_pipeline.py::test_forest_kernel_pads_both_axes:
# random tables, arbitrary feature ids, ragged N and T
@pytest.mark.parametrize("n,T,bt", [(77, 5, 4), (130, 3, 8), (9, 12, 5), (257, 25, 8)])
def test_forest_infer_matches_reference_random(n, T, bt):
    R = np.random.default_rng(T)
    depth, F, K = 4, 6, 3
    feature = R.integers(0, F, (T, 2 ** depth - 1)).astype(np.int32)
    threshold = R.standard_normal((T, 2 ** depth - 1)).astype(np.float32)
    threshold[:, ::5] = np.inf                     # pass-through slots
    leaf = R.random((T, 2 ** depth, K)).astype(np.float32)
    x = R.standard_normal((n, F)).astype(np.float32)
    got = forest_infer_plain(torch.from_numpy(x), torch.from_numpy(feature),
                             torch.from_numpy(threshold), torch.from_numpy(leaf),
                             depth, block_t=bt)
    jargs = (jnp.asarray(x), jnp.asarray(feature), jnp.asarray(threshold),
             jnp.asarray(leaf), depth)
    _check(got, j_kernel_call(*jargs, block_n=32, block_t=bt, interpret=True),
           jref.forest_infer_ref(*jargs))


@pytest.mark.parametrize("T,bt", [(5, 4), (8, 8), (25, 8), (3, 5)])
def test_pad_forest_blocks_identical(T, bt):
    R = np.random.default_rng(0)
    feature = R.integers(0, 4, (T, 7)).astype(np.int32)
    threshold = R.standard_normal((T, 7)).astype(np.float32)
    leaf = R.random((T, 8, 3)).astype(np.float32)
    want = j_pad(jnp.asarray(feature), jnp.asarray(threshold),
                 jnp.asarray(leaf), bt)
    got = pad_forest_blocks(torch.from_numpy(feature), torch.from_numpy(threshold),
                            torch.from_numpy(leaf), bt)
    assert got[3] == want[3]
    for g, w in zip(got[:3], want[:3]):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_straddled_flows_on_a_hand_built_tie():
    # one depth-2 tree: root splits feature 0 at 1.0, its right child
    # splits feature 1 at 5.0; its left child is a pass-through slot
    feature = np.array([[0, 0, 1]], np.int32)
    threshold = np.array([[1.0, np.inf, 5.0]], np.float32)
    up = np.nextafter(np.float32(1.0), np.float32(2.0))
    xa = np.array([[1.0, 0.0],    # tie at the root: a <= 1.0 goes left ...
                   [3.0, 5.0],    # tie at the right child, equal on both sides
                   [3.0, 5.0],    # ... and here the sides differ across it
                   [0.5, 9.0],    # below the root, feature 1 never read
                   [0.5, 9.0]], np.float32)
    xb = np.array([[up, 0.0],     # ... while one ulp up goes right
                   [3.0, 5.0],
                   [3.0, np.nextafter(np.float32(5.0), np.float32(9.0))],
                   [0.5, 9.0],
                   [0.7, 9.0]], np.float32)
    got = ref.straddled_flows(xa, xb, feature, threshold, 2)
    np.testing.assert_array_equal(got, [True, False, True, False, False])
    # and the two sides' outputs differ only on the straddled flows
    leaf = np.arange(4, dtype=np.float32).reshape(1, 4, 1)
    args = (torch.from_numpy(feature), torch.from_numpy(threshold),
            torch.from_numpy(leaf), 2)
    pa = ref.forest_infer_ref(torch.from_numpy(xa), *args).numpy()[:, 0]
    pb = ref.forest_infer_ref(torch.from_numpy(xb), *args).numpy()[:, 0]
    np.testing.assert_array_equal(pa != pb, [True, False, True, False, False])


def test_forest_from_numpy_checks_its_input():
    feature = np.zeros((2, 3), np.int64)
    threshold = np.zeros((2, 3))
    leaf = np.zeros((2, 4, 5))
    f = forest_from_numpy(feature, threshold, leaf, 2, 4, classes=[1, 2, 3, 4, 5])
    assert f.feature.dtype == np.int32 and f.threshold.dtype == np.float32
    with pytest.raises(ValueError, match="dense forest"):
        forest_from_numpy(feature, threshold, leaf, 3, 4)
    with pytest.raises(ValueError, match="feature ids"):
        forest_from_numpy(feature + 4, threshold, leaf, 2, 4)
