"""B5's plain version (masked per-flow statistics) against the JAX package:
`repro.kernels.ops.flow_stats` (the Pallas kernel in interpret mode) and
`repro.kernels.ref.flow_stats_ref`, at the shapes of
`tests/test_kernels.py`'s sweep and `tests/test_fused_pipeline.py`'s
ragged-row cases, with bool, uint8 and int32 masks and an empty mask.

Count, min and max are exact on both sides. Sum and sum of squares are
held to ``rtol=1e-5, atol=1e-5``: XLA adds a row in its own order above 32
packets, and packet sizes up to 1500 give sums of squares near 1e8, where
an absolute tolerance alone would be below one float32 ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.feature_extract import flow_stats_kernel_call as j_kernel_call
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.feature_extract import (
    MAX_PARTS,
    SPAN,
    flow_stats_kernel_call,
    flow_stats_plain,
    mask_u8,
    split_plan,
)
from repro_torch.traffic.synth import make_dataset

SUM_TOL = dict(rtol=1e-5, atol=1e-5)
SHAPES = [(64, 32), (300, 96), (1000, 128),          # test_kernels.py:101
          (73, 17), (5, 8), (256, 12)]               # test_fused_pipeline.py:114
MASK_DTYPES = {"bool": torch.bool, "uint8": torch.uint8, "int32": torch.int32}


def _inputs(n, P, seed, scale=1.0):
    R = np.random.default_rng(seed)
    v = (R.standard_normal((n, P)) * scale).astype(np.float32)
    m = R.random((n, P)) < 0.4
    m[0] = False                         # one empty row in every case
    return v, m


def _assert_stats(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, [0, 3, 4]], want[:, [0, 3, 4]])
    np.testing.assert_allclose(got[:, 1:3], want[:, 1:3], **SUM_TOL)


@pytest.mark.parametrize("mask_dtype", sorted(MASK_DTYPES))
@pytest.mark.parametrize("n,P", SHAPES)
def test_flow_stats_matches_reference(n, P, mask_dtype):
    v, m = _inputs(n, P, seed=n * 1000 + P)
    tv = torch.from_numpy(v)
    tm = torch.from_numpy(m).to(MASK_DTYPES[mask_dtype])
    got = ops.flow_stats(tv, tm)
    assert got.dtype == torch.float32 and got.shape == (n, 5)
    np.testing.assert_array_equal(got.numpy(), flow_stats_plain(tv, tm).numpy())
    jm = jnp.asarray(m)
    want = jops.flow_stats(jnp.asarray(v), jm, block_n=128)
    _assert_stats(got, want)
    _assert_stats(got, jref.flow_stats_ref(jnp.asarray(v), jm))
    # the port's oracle agrees with the reference's to the same tolerance
    _assert_stats(tref.flow_stats_ref(tv, tm), want)
    assert np.all(got.numpy()[0] == 0)


@pytest.mark.parametrize("n,P", SHAPES)
def test_flow_stats_empty_mask(n, P):
    v, _ = _inputs(n, P, seed=P)
    got = ops.flow_stats(torch.from_numpy(v), torch.zeros((n, P), dtype=torch.bool))
    assert np.all(got.numpy() == 0)


@pytest.mark.parametrize("n,P,bn", [(73, 17, 32), (5, 8, 512), (256, 12, 64)])
def test_flow_stats_unpadded_edge_matches_padded_kernel(n, P, bn):
    """The reference pads the row axis to its block; the port masks it.
    Both give the same rows."""
    v, m = _inputs(n, P, seed=bn)
    got = flow_stats_plain(torch.from_numpy(v), torch.from_numpy(m))
    want = j_kernel_call(jnp.asarray(v), jnp.asarray(m), block_n=bn,
                         interpret=True)
    _assert_stats(got, want)


def test_flow_stats_on_packet_sizes():
    """Real windows: packet sizes of up to 1500 bytes masked by each flow's
    valid packets, 128 packets a flow, so the sums of squares reach ~1e8."""
    ds = make_dataset("iot-class", n_flows=200, max_pkts=128, seed=0)
    valid = np.arange(ds.max_pkts)[None, :] < ds.flow_len[:, None]
    v = np.ascontiguousarray(ds.size, np.float32)
    got = ops.flow_stats(torch.from_numpy(v), torch.from_numpy(valid))
    _assert_stats(got, jops.flow_stats(jnp.asarray(v), jnp.asarray(valid),
                                       block_n=128))
    assert float(got[:, 2].max()) > 1e6


def test_flow_stats_lane_order():
    """The plain version sums each lane's groups of 4 consecutive packets
    in order, then the lanes in the kernel's butterfly order, not the row
    left to right nor lane l over packets l, l + 32, ...: with values whose
    sums round differently in the three orders, it keeps the groups' and
    butterfly's result."""
    P = 128
    v = np.ones((1, P), np.float32)
    v[0, 0], v[0, 64] = 1e8, -1e8      # lanes 0 and 16, first in their group
    m = np.ones((1, P), bool)
    got = flow_stats_plain(torch.from_numpy(v), torch.from_numpy(m))
    # lane 0 holds 1e8 and lane 16 -1e8, each having lost its 3 ones; they
    # cancel first in the butterfly (offset 16), and the other 30 lanes'
    # 4 ones each survive
    assert float(got[0, 1]) == 120.0
    # left to right, the 63 ones after 1e8 are lost
    assert float(np.cumsum(v[0], dtype=np.float32)[-1]) == 63.0
    # lane l over packets l, l + 32, ... (the kernel's earlier order): lane
    # 0 keeps 1 of its ones, every other lane its 4
    strided = [np.cumsum(v[0, lane::32], dtype=np.float32)[-1]
               for lane in range(32)]
    assert float(strided[0]) == 1.0 and sum(strided[1:]) == 124.0


def _split_order_reference(v: np.ndarray, m: np.ndarray) -> np.ndarray:
    """The kernel's order written out with scalar float32 steps: each part
    of `split_plan`, each lane's groups of 4 and their packets in order
    (packets past the row skipped), the xor butterfly, the parts in
    order."""
    N, P = v.shape
    parts, part_len = split_plan(P)
    f32 = np.float32
    out = np.zeros((N, 5), np.float32)
    for n in range(N):
        per_part = []
        for w in range(parts):
            lanes = []
            for lane in range(32):
                c = s = sq = f32(0)
                mn, mx = f32(3.4e38), f32(-3.4e38)
                for p0 in range(w * part_len + 4 * lane,
                                min((w + 1) * part_len, P), SPAN):
                    for p in range(p0, min(p0 + 4, P)):
                        x, mf = f32(v[n, p]), f32(m[n, p])
                        c, s, sq = c + mf, s + x * mf, sq + (x * x) * mf
                        if m[n, p]:
                            mn, mx = min(mn, x), max(mx, x)
                lanes.append([c, s, sq, mn, mx])
            width = 32
            while width > 1:
                width //= 2
                lanes = [[a + b for a, b in zip(lo[:3], hi[:3])]
                         + [min(lo[3], hi[3]), max(lo[4], hi[4])]
                         for lo, hi in zip(lanes[:width], lanes[width:])]
            per_part.append(lanes[0])
        acc = per_part[0]
        for x in per_part[1:]:
            acc = [acc[0] + x[0], acc[1] + x[1], acc[2] + x[2],
                   min(acc[3], x[3]), max(acc[4], x[4])]
        if acc[0] == 0:
            acc[3] = acc[4] = f32(0)
        out[n] = acc
    return out


@pytest.mark.parametrize("P", [0, 1, 17, 127, 128, 129, 511, 512, 513, 1000,
                               4000, 4097, 5000])
def test_flow_stats_plain_repeats_the_split_order(P):
    """The plain version's vectorised parts, groups and merges give, bit
    for bit, the order written out step by step, below, at and above the
    split's multiples (scaled normals, so that the order shows in the
    sums)."""
    v, m = _inputs(3, P, seed=P + 7, scale=1e3)
    got = flow_stats_plain(torch.from_numpy(v), torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, _split_order_reference(v, m))


@pytest.mark.parametrize("P,want", [
    (0, (1, 128)), (128, (1, 128)), (512, (1, 512)), (513, (2, 384)),
    (1000, (2, 512)), (2048, (4, 512)), (4000, (8, 512)), (4097, (8, 640)),
    (100_000, (8, 12_544))])
def test_split_plan(P, want):
    """The fewest parts (at most 8) that keep a warp at 4 steps of 128
    packets; the parts cover the row, each whole steps (the last parts may
    lie past the row: each adds the empty statistics)."""
    parts, part_len = split_plan(P)
    assert (parts, part_len) == want
    assert parts in (1, 2, 4, MAX_PARTS) and part_len % SPAN == 0
    assert parts * part_len >= P


def test_flow_stats_kernel_call_refuses_cpu_and_bad_inputs():
    v = torch.zeros((4, 8))
    m = torch.ones((4, 8), dtype=torch.bool)
    with pytest.raises(ValueError):
        flow_stats_kernel_call(v, m)          # a CPU tensor: no kernel here
    with pytest.raises(TypeError):
        flow_stats_kernel_call(v, m.float())
    with pytest.raises(ValueError):
        flow_stats_kernel_call(v[0], m[0])
    with pytest.raises(ValueError):
        flow_stats_plain(v, m[:, :4])


def test_mask_u8():
    m = torch.tensor([[True, False], [False, True]])
    assert mask_u8(m).dtype == torch.uint8
    assert mask_u8(m).data_ptr() == m.data_ptr()      # a view, no copy
    i = torch.tensor([[2, 0], [0, -1]], dtype=torch.int32)
    assert mask_u8(i).tolist() == [[1, 0], [0, 1]]
    assert mask_u8(m.t()).is_contiguous()
