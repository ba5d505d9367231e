"""The LM kernels' plain versions (B6 flash attention, B7 decode attention,
B8 Mamba scan) against the JAX package: its Pallas kernels in interpret
mode at `tests/test_kernels.py`'s sweep shapes and tolerances, and its jnp
oracles at ragged shapes the Pallas wrappers do not take."""
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.ssm import chunked_ssd as j_chunked_ssd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import (
    MAX_SPLIT_LEN,
    SPLIT_TILE,
    decode_attention_kernel_call,
    decode_attention_plain,
    split_plan,
)
from repro_torch.kernels.flash_attention import (
    TILE_HEAD_DIMS,
    flash_attention_kernel_call,
    flash_attention_plain,
    pad_head,
    tile_width,
)
from repro_torch import configs
from repro_torch.kernels.mamba_scan import (
    MAX_CHUNK,
    MAX_SHARED_BYTES,
    mamba_scan_kernel_call,
    mamba_scan_plain,
    scan_scratch_shapes,
    scan_shared_bytes,
)
from repro_torch.models.ssm import _HEAD_P, chunked_ssd

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _pair(R, shape, dtype="float32", scale=1.0):
    a = (R.standard_normal(shape) * scale).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def _mamba_inputs(R, B, T, H, P, S):
    x = _pair(R, (B, T, H, P), scale=0.5)
    dt_np = (np.abs(R.standard_normal((B, T, H)) * 0.1) + 0.01).astype(np.float32)
    A_np = (-np.abs(R.standard_normal(H)) - 0.1).astype(np.float32)
    Bm = _pair(R, (B, T, S), scale=0.3)
    Cm = _pair(R, (B, T, S), scale=0.3)
    return (x, (jnp.asarray(dt_np), torch.from_numpy(dt_np)),
            (jnp.asarray(A_np), torch.from_numpy(A_np)), Bm, Cm)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D", [
    (1, 2, 2, 128, 128, 32),
    (2, 4, 2, 256, 256, 64),
    (1, 8, 1, 128, 256, 64),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(B, Hq, Hkv, Tq, Tk, D, causal,
                                              dtype):
    R = np.random.default_rng(B * 100 + Tq + D)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(R, (B, h, t, D), dtype) for h, t in
                                    ((Hq, Tq), (Hkv, Tk), (Hkv, Tk)))
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64)
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


@pytest.mark.parametrize("Tq,Tk,causal", [
    (192, 256, True),    # chunked prefill: a causal offset of 64
    (200, 200, True),    # ragged: no block multiple
    (200, 200, False),
    (37, 300, True),
    (300, 37, False),
])
def test_flash_attention_plain_matches_oracle_ragged(Tq, Tk, causal):
    R = np.random.default_rng(Tq * Tk)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(R, (2, h, t, 64)) for h, t in
                                    ((4, Tq), (2, Tk), (2, Tk)))
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)
    # the port's own oracle agrees with the reference's
    np.testing.assert_allclose(_np(tref.flash_attention_ref(tq, tk, tv,
                                                            causal=causal)),
                               _np(want), atol=2e-5)


FA_BF16_CASES = {"aligned": (1, 4, 2, 128, 128), "chunked": (2, 4, 1, 128, 256),
                 "ragged": (1, 4, 2, 200, 328)}


@pytest.mark.parametrize("case", list(FA_BF16_CASES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_flash_attention_bf16_plain_in_kernel_order(case, causal, D):
    """The bf16 plain version in the tensor-core kernel's order (P rounded
    to bf16 before P V, l over the rounded P) stays within one bf16
    rounding of the Pallas kernel (at block multiples, which it takes
    unpadded) and of the jnp oracle."""
    B, Hq, Hkv, Tq, Tk = FA_BF16_CASES[case]
    R = np.random.default_rng(Tq * D + Tk)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(R, (B, h, t, D), "bfloat16") for h, t
                                    in ((Hq, Tq), (Hkv, Tk), (Hkv, Tk)))
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == tq.shape
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)
    if case != "ragged":
        want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                    block_k=64)
        np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)


def _flash_attention_plain_f32_before(q, k, v, causal):
    """The plain version's loop as it stood before the bf16 kernel moved
    to tensor cores (64-key tiles, the lane butterfly), kept frozen here."""
    B, Hq, Tq, D = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    scale = D ** -0.5
    pad = (-Tk) % 64
    kf = torch.nn.functional.pad(k.float(), (0, 0, 0, pad)).repeat_interleave(g, dim=1)
    vf = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).repeat_interleave(g, dim=1)
    qf = q.float()
    qpos = torch.arange(Tq)[:, None] + (Tk - Tq)
    m = torch.full((B, Hq, Tq, 1), -1e30)
    l = torch.zeros((B, Hq, Tq, 1))
    acc = torch.zeros((B, Hq, Tq, D))

    def lane_sum(p):
        x = p[..., :32] + p[..., 32:]
        for w in (16, 8, 4, 2, 1):
            x = x[..., :w] + x[..., w:2 * w]
        return x

    for k0 in range(0, Tk + pad, 64):
        s = torch.matmul(qf, kf[:, :, k0:k0 + 64].transpose(-1, -2)) * scale
        key = k0 + torch.arange(64)[None, :]
        valid = key < Tk
        if causal:
            valid = valid & (key <= qpos)
        m_new = torch.maximum(
            m, s.masked_fill(~valid, -1e30).amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new), torch.zeros_like(s))
        l = l * alpha + lane_sum(p)
        acc = acc * alpha + torch.matmul(p, vf[:, :, k0:k0 + 64])
        m = m_new
    out = torch.where(l > 0, acc / l, torch.zeros_like(acc))
    return out.to(q.dtype)


@pytest.mark.parametrize("shape", [(1, 2, 2, 64, 64, 32), (2, 4, 2, 200, 328, 128),
                                   (1, 2, 1, 48, 40, 64)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_plain_is_unchanged(shape, causal):
    """The float32 plain version is bitwise what it was: the scalar float32
    kernel it mirrors did not change."""
    B, Hq, Hkv, Tq, Tk, D = shape
    R = np.random.default_rng(Tq + Tk + D)
    _, q = _pair(R, (B, Hq, Tq, D))
    _, k = _pair(R, (B, Hkv, Tk, D))
    _, v = _pair(R, (B, Hkv, Tk, D))
    assert torch.equal(flash_attention_plain(q, k, v, causal=causal),
                       _flash_attention_plain_f32_before(q, k, v, causal))


def test_flash_attention_row_without_keys_is_zero():
    """Causal with Tq > Tk: the first Tq - Tk rows see no key. The kernel's
    guard gives 0 there (the jnp oracle gives NaN); every other row agrees
    with the oracle."""
    R = np.random.default_rng(5)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(R, (1, 2, t, 32)) for t in (48, 40, 40))
    got = _np(flash_attention_plain(tq, tk, tv, causal=True))
    assert np.all(got[:, :, :8] == 0)
    want = _np(jref.flash_attention_ref(jq, jk, jv, causal=True))
    np.testing.assert_allclose(got[:, :, 8:], want[:, :, 8:], atol=2e-5)


# the reduced configs' head dims: yi-34b 8, starcoder2-7b 12, qwen3-8b 16,
# phi3-medium-14b 20; each runs the 32-wide kernels on zero-padded rows
SMALL_HEAD_DIMS = (8, 12, 16, 20)


@pytest.mark.parametrize("D", SMALL_HEAD_DIMS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_small_head_dims(D, causal, dtype):
    """B6's plain version at the reduced configs' head dims, 7 query heads
    a kv head (yi-34b's): against the Pallas kernel in interpret mode at
    block multiples (chunked prefill, Tq < Tk) and the jnp oracle at
    ragged lengths, within the D 32-128 cases' tolerances."""
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    R = np.random.default_rng(D * 10 + causal)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(R, (1, h, t, D), dtype) for h, t in
                                    ((7, 64), (1, 128), (1, 128)))
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jops.flash_attention(jq, jk, jv, causal=causal, block_q=64,
                                block_k=64)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(R, (2, h, t, D), dtype) for h, t in
                                    ((7, 77), (1, 200), (1, 200)))
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    want = jref.flash_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)


@pytest.mark.parametrize("D", SMALL_HEAD_DIMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_small_head_dims(D, dtype):
    """B7's plain version at the reduced configs' head dims: against the
    Pallas kernel in interpret mode (G 7, the reference's padded cache
    path), and against the jnp oracle at lengths 0, 1, S and either side
    of each split boundary (0 where the length is 0)."""
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    R = np.random.default_rng(D + 1)
    B, Hq, Hkv, S = 2, 14, 2, 300
    jq, tq = _pair(R, (B, Hq, D), dtype)
    jk, tk = _pair(R, (B, S, Hkv, D), dtype)
    jv, tv = _pair(R, (B, S, Hkv, D), dtype)
    lens = R.integers(1, S + 1, B).astype(np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_s=128)
    got = decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == tq.dtype and got.shape == tq.shape
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    n_split, split_len = split_plan(1, 1, S)
    assert n_split > 1
    jq, tq = _pair(R, (1, 7, D), dtype)
    jk, tk = _pair(R, (1, S, 1, D), dtype)
    jv, tv = _pair(R, (1, S, 1, D), dtype)
    for n in _split_lengths(S, split_len):
        lens = np.array([n], np.int32)
        got = _np(decode_attention_plain(tq, tk, tv, torch.from_numpy(lens)))
        if n == 0:
            assert np.all(got == 0)
            continue
        want = _np(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)))
        np.testing.assert_allclose(got, want, atol=tol)


@pytest.mark.parametrize("D", [2, 8, 12, 16, 20, 40, 96])
def test_small_head_dims_run_the_tile_width_on_padded_rows(D):
    """Both plain versions at a head dim below a tile width are, bit for
    bit, their own run at the tile width on zero-padded rows, sliced: the
    layout the kernels use."""
    width = tile_width(D)
    assert width == next(w for w in TILE_HEAD_DIMS if w >= D)
    R = np.random.default_rng(D)
    _, q = _pair(R, (1, 6, 70, D))
    _, k = _pair(R, (1, 2, 90, D))
    scale = D ** -0.5
    got = flash_attention_plain(q, k, k, scale=scale)
    want = flash_attention_plain(pad_head(q, width), pad_head(k, width),
                                 pad_head(k, width), scale=scale)[..., :D]
    assert torch.equal(got, want)
    qd, kc = q[:, :, 0].contiguous(), k.transpose(1, 2).contiguous()
    lens = torch.tensor([61], dtype=torch.int32)
    got = decode_attention_plain(qd, kc, kc, lens)
    want = decode_attention_plain(pad_head(qd, width), pad_head(kc, width),
                                  pad_head(kc, width), lens,
                                  scale=scale)[..., :D]
    assert torch.equal(got, want)


@pytest.mark.parametrize("D", [0, 7, 13, 130, 256])
def test_kernel_calls_refuse_head_dims_no_kernel_takes(D):
    """An odd head dim or one above 128 raises with the rule before any
    device check; the plain versions still compute it."""
    assert tile_width(D) is None
    R = np.random.default_rng(1)
    _, q = _pair(R, (1, 2, 5, D))
    with pytest.raises(ValueError, match="even head dim from 2 to 128"):
        flash_attention_kernel_call(q, q, q)
    qd, kc = q[:, :, 0].contiguous(), q.transpose(1, 2).contiguous()
    lens = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="even head dim from 2 to 128"):
        decode_attention_kernel_call(qd, kc, kc, lens)
    if D:
        assert flash_attention_plain(q, q, q).shape == q.shape
        assert decode_attention_plain(qd, kc, kc, lens).shape == qd.shape


@pytest.mark.parametrize("B,Hq,Hkv,S,D,bs", [
    (2, 4, 2, 256, 64, 128),
    (3, 8, 8, 512, 32, 256),   # MHA
    (1, 16, 2, 300, 64, 128),  # padding path of the reference
])
def test_decode_attention_plain_matches_pallas(B, Hq, Hkv, S, D, bs):
    R = np.random.default_rng(S + D)
    jq, tq = _pair(R, (B, Hq, D))
    jk, tk = _pair(R, (B, S, Hkv, D))
    jv, tv = _pair(R, (B, S, Hkv, D))
    lens = R.integers(1, S + 1, B).astype(np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_s=bs)
    got = decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_oracle_ragged(dtype):
    R = np.random.default_rng(300)
    B, Hq, Hkv, S, D = 4, 8, 2, 300, 128
    jq, tq = _pair(R, (B, Hq, D), dtype)
    jk, tk = _pair(R, (B, S, Hkv, D), dtype)
    jv, tv = _pair(R, (B, S, Hkv, D), dtype)
    lens = np.array([1, 299, 300, 17], np.int32)
    want = jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens))
    got = decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    np.testing.assert_allclose(_np(got), _np(want), atol=tol)
    np.testing.assert_allclose(
        _np(tref.decode_attention_ref(tq, tk, tv, torch.from_numpy(lens))),
        _np(want), atol=tol)
    # a sequence of length 0 gives 0 (the oracle gives NaN)
    zero = decode_attention_plain(tq, tk, tv, torch.zeros(B, dtype=torch.int32))
    assert torch.all(zero == 0)


@pytest.mark.parametrize("B,Hq,Hkv,S,D,bs", [
    (2, 4, 2, 256, 64, 128),
    (1, 16, 2, 300, 64, 128),
    (4, 32, 8, 512, 128, 256),
])
def test_decode_attention_plain_matches_pallas_bf16(B, Hq, Hkv, S, D, bs):
    """The split plain version on bf16 inputs against the Pallas kernel in
    interpret mode (both compute in float32 and round the output to
    bf16: one bf16 rounding apart)."""
    R = np.random.default_rng(S + D + 1)
    jq, tq = _pair(R, (B, Hq, D), "bfloat16")
    jk, tk = _pair(R, (B, S, Hkv, D), "bfloat16")
    jv, tv = _pair(R, (B, S, Hkv, D), "bfloat16")
    lens = R.integers(1, S + 1, B).astype(np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lens), block_s=bs)
    got = decode_attention_plain(tq, tk, tv, torch.from_numpy(lens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2)


def _split_lengths(S: int, split_len: int) -> list[int]:
    """Lengths 0, 1, S and one either side of every split boundary."""
    out = {0, 1, S}
    for edge in range(split_len, S, split_len):
        out.update((edge - 1, edge, edge + 1))
    return sorted(out)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (1, 4, 1, 200, 64),    # 4 splits of 64
    (1, 2, 2, 130, 128),   # 3 splits, the last of 2 positions
    (2, 8, 2, 256, 32),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_at_split_edges(B, Hq, Hkv, S, D, dtype):
    """Lengths 0, 1, S and split boundaries +-1, with several splits at a
    small S: the plain version against the jnp oracle (0 where the length
    is 0, where the oracle gives NaN)."""
    n_split, split_len = split_plan(B, Hkv, S)
    assert n_split > 1
    R = np.random.default_rng(S * D)
    jq, tq = _pair(R, (B, Hq, D), dtype)
    jk, tk = _pair(R, (B, S, Hkv, D), dtype)
    jv, tv = _pair(R, (B, S, Hkv, D), dtype)
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for n in _split_lengths(S, split_len):
        lens = np.full(B, n, np.int32)
        lens[-1] = S - n          # the other sequence at another edge
        got = _np(decode_attention_plain(tq, tk, tv, torch.from_numpy(lens)))
        want = _np(jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)))
        for b in range(B):
            if lens[b] == 0:
                assert np.all(got[b] == 0)
            else:
                np.testing.assert_allclose(got[b], want[b], atol=tol)


@pytest.mark.parametrize("B,Hkv,S", [
    (8, 8, 4096),     # qwen3-8b's timed shape
    (8, 32, 168),     # zamba2-1.2b's served cache
    (1, 1, 1), (1, 1, 64), (1, 1, 65), (2, 8, 300), (1, 2, 32768),
    (64, 8, 4096), (1, 1, 0),
])
def test_split_plan(B, Hkv, S):
    """The split count is a function of (B, Hkv, S) only: whole tiles of
    at least SPLIT_TILE positions, at most MAX_SPLIT_LEN, covering S with
    no split wholly past it."""
    assert list(inspect.signature(split_plan).parameters) == ["B", "Hkv", "S"]
    n_split, split_len = split_plan(B, Hkv, S)
    assert split_plan(B, Hkv, S) == (n_split, split_len)
    assert split_len % SPLIT_TILE == 0
    assert SPLIT_TILE <= split_len <= MAX_SPLIT_LEN
    assert n_split >= 1 and n_split * split_len >= S
    assert (n_split - 1) * split_len < max(S, 1)
    if (B, Hkv, S) == (8, 8, 4096):
        # about 8 blocks per SM of the H100's 132: 16 splits of 256
        assert (n_split, split_len) == (16, 256)
        assert 6 * 132 <= B * Hkv * n_split <= 10 * 132


def _decode_attention_plain_before(q, k_cache, v_cache, lengths):
    """The plain version before the split kernel: a one-pass softmax over
    the whole cache (frozen copy)."""
    B, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, D).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, k_cache.float()) * D ** -0.5
    valid = (torch.arange(S)[None, :] < lengths[:, None])[:, None, None, :]
    s = s.masked_fill(~valid, -1e30)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~valid, 0.0)
    den = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    out = out / torch.where(den > 0, den, torch.ones_like(den))
    return out.reshape(B, Hq, D).to(q.dtype)


@pytest.mark.parametrize("B,Hq,Hkv,S,D", [
    (2, 4, 2, 256, 64), (3, 8, 8, 512, 32), (4, 32, 8, 300, 128),
    (2, 9, 1, 77, 128), (2, 4, 2, 50, 20)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_near_one_pass(B, Hq, Hkv, S, D, dtype):
    """The split plain version against the one-pass version it replaced:
    float32 within 2e-6 (sums in another order, outputs of magnitude ~1),
    bf16 within one bf16 rounding of the output (2^-7 relative)."""
    R = np.random.default_rng(B * S + D)
    _, q = _pair(R, (B, Hq, D), dtype)
    _, k = _pair(R, (B, S, Hkv, D), dtype)
    _, v = _pair(R, (B, S, Hkv, D), dtype)
    lens = torch.from_numpy(R.integers(0, S + 1, B).astype(np.int32))
    got = decode_attention_plain(q, k, v, lens)
    want = _decode_attention_plain_before(q, k, v, lens)
    assert got.dtype == want.dtype
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-6)


@pytest.mark.parametrize("B,T,H,P,S,chunk", [
    (1, 128, 2, 16, 8, 32),
    (2, 256, 4, 32, 16, 64),
    (1, 192, 1, 64, 4, 64),
])
def test_mamba_scan_plain_matches_pallas(B, T, H, P, S, chunk):
    R = np.random.default_rng(T + P)
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _mamba_inputs(
        R, B, T, H, P, S)
    want = jops.mamba_scan(jx, jdt, jA, jB, jC, chunk=chunk)
    y, h = mamba_scan_plain(tx, tdt, tA, tB, tC, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(want), atol=3e-4)
    # the final state: the reference's model-side chunked SSD keeps it
    _, h_want = j_chunked_ssd(jx, jdt * jA, jdt, jB[:, :, None], jC[:, :, None],
                              chunk=chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_want), atol=3e-4)


@pytest.mark.parametrize("T,chunk", [(200, 64), (77, 128), (130, 128)])
def test_mamba_scan_plain_matches_oracle_ragged(T, chunk):
    """Any T: a ragged last chunk acts as zero padding (the reference's
    `ops.mamba_scan` pads; its raw kernel and `chunked_ssd` refuse)."""
    R = np.random.default_rng(T)
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _mamba_inputs(
        R, 2, T, 3, 16, 8)
    want = jref.mamba_scan_ref(jx, jdt, jA, jB, jC)
    y, h = mamba_scan_plain(tx, tdt, tA, tB, tC, chunk=chunk)
    np.testing.assert_allclose(_np(y), _np(want), atol=3e-4)
    np.testing.assert_allclose(_np(tref.mamba_scan_ref(tx, tdt, tA, tB, tC)),
                               _np(want), atol=3e-4)
    # the final state is the sequential recurrence's after step T
    _, h_whole = mamba_scan_plain(tx, tdt, tA, tB, tC, chunk=T)
    np.testing.assert_allclose(h.numpy(), h_whole.numpy(), atol=3e-4)
    if T > chunk:   # the model-side form keeps the reference's assertion
        with pytest.raises(ValueError, match="multiple"):
            chunked_ssd(tx, tdt * tA, tdt, tB[:, :, None], tC[:, :, None],
                        chunk=chunk)


@pytest.mark.parametrize("G", [1, 3])
def test_chunked_ssd_matches_reference(G):
    """The port's copy of the model-side chunked SSD, shared (G = 1, the
    Mamba-2 form) and per-head (G = H, the mLSTM form) keys."""
    R = np.random.default_rng(G)
    B, T, H, P, S = 2, 128, 3, 16, 8
    jx, tx = _pair(R, (B, T, H, P), scale=0.5)
    ld = (-np.abs(R.standard_normal((B, T, H))) * 0.1).astype(np.float32)
    sc = R.random((B, T, H)).astype(np.float32)
    jB, tB = _pair(R, (B, T, G, S), scale=0.3)
    jC, tC = _pair(R, (B, T, G, S), scale=0.3)
    yw, hw = j_chunked_ssd(jx, jnp.asarray(ld), jnp.asarray(sc), jB, jC, chunk=32)
    y, h = chunked_ssd(tx, torch.from_numpy(ld), torch.from_numpy(sc), tB, tC,
                       chunk=32)
    np.testing.assert_allclose(_np(y), _np(yw), atol=3e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(hw), atol=3e-5)


def test_cpu_tensors_take_the_plain_versions():
    """The dispatchers send CPU tensors to the plain versions: no launch is
    counted, and the kernel calls refuse CPU tensors."""
    R = np.random.default_rng(0)
    _, q = _pair(R, (1, 2, 16, 32))
    _, k = _pair(R, (1, 1, 16, 32))
    counters = (flash_attention_kernel_call, decode_attention_kernel_call,
                mamba_scan_kernel_call)
    before = [f.launches for f in counters]
    torch.testing.assert_close(ops.flash_attention(q, k, k),
                               flash_attention_plain(q, k, k), rtol=0, atol=0)
    lens = torch.tensor([5], dtype=torch.int32)
    qd, kc = q[:, :, 0].contiguous(), k.transpose(1, 2).contiguous()
    torch.testing.assert_close(ops.decode_attention(qd, kc, kc, lens),
                               decode_attention_plain(qd, kc, kc, lens),
                               rtol=0, atol=0)
    (_, x), (_, dt), (_, A), (_, Bm), (_, Cm) = _mamba_inputs(R, 1, 40, 2, 8, 4)
    y, h = ops.mamba_scan(x, dt, A, Bm, Cm, chunk=16)
    y2, h2 = mamba_scan_plain(x, dt, A, Bm, Cm, chunk=16)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert [f.launches for f in counters] == before == [0, 0, 0]
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_kernel_call(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        decode_attention_kernel_call(qd, kc, kc, lens)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_kernel_call(x, dt, A, Bm, Cm, chunk=16)


# an H100 SM's shared memory; each resident block also reserves 1 KB
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES = 233_472, 1024
# every registered config whose layers reach B8 (the hybrid family's
# Mamba-2 layers), at full and reduced scale
B8_CONFIGS = tuple(
    (name, scale) for name in configs.all_arch_ids()
    for scale, get in (("full", configs.get), ("reduced", configs.get_reduced))
    if get(name).family == "hybrid")


@pytest.mark.parametrize("name,scale", B8_CONFIGS)
def test_scan_shared_memory_fits_every_config_reaching_b8(name, scale):
    """The scan's blocks fit a block's shared memory at every config that
    runs it, and two of them fit an SM."""
    cfg = (configs.get if scale == "full" else configs.get_reduced)(name)
    assert cfg.ssd_chunk <= MAX_CHUNK
    need = scan_shared_bytes(cfg.ssd_chunk, _HEAD_P, cfg.ssm_state)
    assert need <= MAX_SHARED_BYTES
    assert 2 * (need + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    assert ("zamba2-1.2b", "full") in B8_CONFIGS


@pytest.mark.parametrize("chunk,P,S,want", [
    (128, 64, 64, 94_720),    # zamba2-1.2b: the chunk scan's block
    (128, 64, 16, 56_320),    # its reduced config
    (40, 8, 4, 46_720),
    (128, 254, 4, 134_656),   # the chunk state's, rows padded to 4 floats
])
def test_scan_shared_bytes_of_the_layout(chunk, P, S, want):
    """`scan_shared_bytes` counts the source's layout: the largest of the
    C B^T pass's (C and B transposed), the chunk state's (dt, L, W; dt o x
    and B, rows padded to 4 floats) and the chunk scan's (dt, L, exp L; C
    transposed, 132-float rows; a strip's dt o x; two strips of M
    transposed; the state's 64 columns)."""
    assert scan_shared_bytes(chunk, P, S) == want


@pytest.mark.parametrize("B,T,H,P,S,chunk,n_chunks", [
    (2, 2048, 64, 64, 64, 128, 16),   # zamba2-1.2b's prefill
    (2, 1000, 8, 64, 16, 128, 8),     # a ragged last chunk
    (2, 200, 3, 64, 16, 64, 4),
    (1, 40, 2, 8, 4, 128, 1),         # T below the chunk: one chunk of T
    (1, 1, 1, 64, 64, 128, 1),
])
def test_scan_scratch_shapes(B, T, H, P, S, chunk, n_chunks):
    """The scratch the kernel call allocates: every chunk's state and
    decay, 33.5 MB at zamba2-1.2b's prefill, and every chunk's C B^T, C
    transposed and B in float32, shared by the heads (2.1, 1.0 and 1.0 MB
    there)."""
    states, decay, cb, ct, bt = scan_scratch_shapes(B, T, H, P, S, chunk)
    assert states == (B, H, n_chunks, P, S) and decay == (B, H, n_chunks)
    assert cb == (B, n_chunks, MAX_CHUNK, MAX_CHUNK)
    assert ct == (B, n_chunks, S, MAX_CHUNK)
    assert bt == (B, n_chunks, MAX_CHUNK, -(-S // 4) * 4)
    if T == 2048:
        assert 4 * int(np.prod(states)) == 33_554_432
        assert 4 * int(np.prod(cb)) == 2_097_152
        assert 4 * int(np.prod(ct)) == 4 * int(np.prod(bt)) == 1_048_576


@pytest.mark.parametrize("S,chunk,match", [(4, MAX_CHUNK + 1, "at most"),
                                           (300, 128, "shared memory")])
def test_scan_kernel_refuses_what_its_blocks_do_not_hold(S, chunk, match):
    R = np.random.default_rng(3)
    (_, x), (_, dt), (_, A), (_, Bm), (_, Cm) = _mamba_inputs(R, 1, 300, 2, 8, S)
    with pytest.raises(ValueError, match=match):
        mamba_scan_kernel_call(x, dt, A, Bm, Cm, chunk=chunk)


# ---------------------------------------------------------------------------
# B6b and B8b: the gradients' plain versions
# ---------------------------------------------------------------------------
# Tolerance, per gradient: rtol 1e-4 plus atol 1e-5 x its largest |entry|
# (float32 sums in other orders than autograd's or XLA's; measured at most
# 2e-6 x the largest).

def _assert_grad_close(got, want, what):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", [
    (2, 4, 2, 37, 37, 16, True),      # GQA, ragged, small head dim
    (1, 2, 1, 20, 50, 12, False),     # Tq != Tk, cross attention
    (2, 2, 2, 70, 90, 64, True),      # causal with an offset
    (1, 3, 1, 9, 9, 8, True),
    (2, 4, 4, 64, 64, 128, False),
    (1, 6, 2, 130, 130, 20, True),
])
def test_flash_attention_bwd_plain_matches_autograd_and_jax(B, Hq, Hkv, Tq, Tk,
                                                            D, causal):
    """B6b's plain version against autograd through the torch ops of B6's
    plain forward (`flash_attention_plain` called on leaves) and against
    `jax.grad` of the reference's jnp attention oracle."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain

    R = np.random.default_rng(B * 1000 + Tq + D)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(R, s) for s in (
        (B, Hq, Tq, D), (B, Hkv, Tk, D), (B, Hkv, Tk, D)))
    jdo, tdo = _pair(R, (B, Hq, Tq, D))
    out = flash_attention_plain(tq, tk, tv, causal=causal)
    got = flash_attention_bwd_plain(tq, tk, tv, out, tdo, causal=causal)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    want = torch.autograd.grad(
        flash_attention_plain(*leaves, causal=causal), leaves, tdo)
    for g, w, name in zip(got, want, "qkv"):
        _assert_grad_close(g, w, f"d{name} vs autograd")

    def f(q, k, v):
        o = jref.flash_attention_ref(q, k, v, causal=causal)
        return jnp.sum(o * jdo)

    want = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)
    for g, w, name in zip(got, want, "qkv"):
        _assert_grad_close(g, w, f"d{name} vs jax.grad")


# bf16 gradients: rtol 2^-8 plus atol 1e-2 x the largest |entry|. B6b's
# bf16 arithmetic rounds P and dS to bf16 before their products and the
# gradients to bf16 at the end (three roundings of at most 2^-9 each);
# measured at most 4.5e-3 x the largest entry against jax.grad in float32
# over the cases below.
def _assert_bf16_grad_close(got, want, what):
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=2 ** -8,
                               atol=1e-2 * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("B,Hq,Hkv,Tq,Tk,D,causal", [
    (2, 4, 2, 37, 37, 16, True),      # GQA, ragged
    (1, 2, 1, 20, 50, 12, False),     # Tq != Tk (cross attention)
    (2, 2, 2, 70, 90, 64, True),      # causal with an offset of 20
    (1, 3, 1, 9, 9, 8, True),
    (2, 4, 4, 64, 64, 128, False),
    (1, 6, 2, 130, 130, 20, True),
    (1, 4, 1, 100, 300, 64, True),    # a causal offset of 200, g = 4
    (2, 4, 2, 128, 128, 128, True),
])
def test_flash_attention_bwd_bf16_plain_matches_jax(B, Hq, Hkv, Tq, Tk, D,
                                                    causal):
    """B6b's bf16 plain version (the tensor-core kernels' arithmetic)
    against `jax.grad` of the reference's jnp attention oracle on the same
    bf16-valued inputs in float32, at the bf16 tolerance above."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain

    R = np.random.default_rng(B * 1000 + Tq + D)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = (
        _pair(R, s, "bfloat16") for s in ((B, Hq, Tq, D), (B, Hkv, Tk, D),
                                          (B, Hkv, Tk, D), (B, Hq, Tq, D)))
    out = flash_attention_plain(tq, tk, tv, causal=causal)
    got = flash_attention_bwd_plain(tq, tk, tv, out, tdo, causal=causal)
    f32 = [jnp.asarray(_np(t)) for t in (tq, tk, tv, tdo)]

    def f(q, k, v):
        return jnp.sum(jref.flash_attention_ref(q, k, v, causal=causal) * f32[3])

    want = jax.grad(f, argnums=(0, 1, 2))(*f32[:3])
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == torch.bfloat16
        _assert_bf16_grad_close(g, w, f"d{name} vs jax.grad")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_bwd_plain_is_the_float32_gradient(dtype):
    """float32: B6b's gradients of inputs already float32 are its float32
    gradients, bitwise. bf16 (the tensor-core kernels' arithmetic): within
    the bf16 tolerance above of the float32 gradients of the same
    bf16-valued inputs."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain

    R = np.random.default_rng(3)
    ts = [_pair(R, s, dtype)[1] for s in ((2, 4, 50, 16), (2, 2, 50, 16),
                                          (2, 2, 50, 16), (2, 4, 50, 16))]
    q, k, v, do = ts
    got = flash_attention_bwd_plain(q, k, v, flash_attention_plain(q, k, v),
                                    do)
    qf, kf, vf, dof = (t.float() for t in ts)
    want = flash_attention_bwd_plain(qf, kf, vf,
                                     flash_attention_plain(qf, kf, vf), dof)
    for g, w in zip(got, want):
        assert g.dtype == ts[0].dtype
        if dtype == "float32":
            assert torch.equal(g, w)
        else:
            _assert_bf16_grad_close(g, w, "bf16 vs float32")


@pytest.mark.parametrize("B,T,H,P,S,chunk,with_dh", [
    (2, 64, 3, 16, 16, 32, False),
    (1, 96, 2, 64, 40, 32, True),
    (2, 50, 2, 32, 64, 16, True),      # ragged T: the forward pads
    (2, 37, 4, 64, 8, 128, False),     # T below the chunk
    (2, 64, 2, 16, 16, 16, False),
    (1, 64, 2, 32, 8, 16, True),
    (2, 64, 3, 16, 16, 32, True),
    (2, 256, 2, 16, 8, 128, False),
    (1, 256, 2, 8, 16, 128, True),
    (2, 300, 2, 16, 8, 128, True),     # a ragged last chunk of 44 steps
])
def test_mamba_scan_bwd_plain_matches_autograd_and_jax(B, T, H, P, S, chunk,
                                                       with_dh):
    """B8b's plain version against autograd through the torch ops of B8's
    plain forward (`mamba_scan_plain` called on leaves), at every T, and
    (T a multiple of the chunk) against `jax.grad` of the reference's
    `chunked_ssd` with one shared group; dh_last given or not."""
    from repro_torch.kernels.mamba_scan import mamba_scan_bwd_plain

    R = np.random.default_rng(T + P + S)
    (jx, tx), (jdt, tdt), (jA, tA), (jB, tB), (jC, tC) = _mamba_inputs(
        R, B, T, H, P, S)
    jdy, tdy = _pair(R, (B, T, H, P))
    jdh, tdh = _pair(R, (B, H, P, S)) if with_dh else (None, None)
    got = mamba_scan_bwd_plain(tx, tdt, tA, tB, tC, tdy, tdh, chunk=chunk)
    leaves = [t.clone().requires_grad_() for t in (tx, tdt, tA, tB, tC)]
    y, h = mamba_scan_plain(*leaves, chunk=chunk)
    loss = (y * tdy).sum() + ((h * tdh).sum() if with_dh else 0)
    want = torch.autograd.grad(loss, leaves)
    names = ("dx", "ddt", "dA", "dBm", "dCm")
    for g, w, name in zip(got, want, names):
        _assert_grad_close(g, w, f"{name} vs autograd")
    if T % min(chunk, T):
        return

    def f(x, dt, A, Bm, Cm):
        y, h = j_chunked_ssd(x, dt * A, dt, Bm[:, :, None], Cm[:, :, None],
                             chunk=chunk)
        out = jnp.sum(y * jdy)
        return out + (jnp.sum(h * jdh) if with_dh else 0.0)

    want = jax.grad(f, argnums=(0, 1, 2, 3, 4))(jx, jdt, jA, jB, jC)
    for g, w, name in zip(got, want, names):
        _assert_grad_close(g, w, f"{name} vs jax.grad")


def test_mamba_scan_bwd_refuses_what_its_kernel_does_not_take():
    """B8b takes what B8 takes: a chunk up to MAX_CHUNK and any P and S
    whose blocks fit (the old limits, P a multiple of 16 up to 64 and S up
    to 64, are gone); CPU tensors go to the plain version."""
    from repro_torch.kernels.mamba_scan import (
        check_bwd_shapes,
        mamba_scan_bwd_kernel_call,
    )

    with pytest.raises(ValueError, match="at most"):
        check_bwd_shapes(MAX_CHUNK + 1, 64, 64)
    with pytest.raises(ValueError, match="shared memory"):
        check_bwd_shapes(128, 8, 300)
    for P, S in ((8, 16), (80, 16), (64, 65), (24, 8), (64, 64), (1, 1)):
        check_bwd_shapes(128, P, S)
    R = np.random.default_rng(0)
    (_, x), (_, dt), (_, A), (_, Bm), (_, Cm) = _mamba_inputs(R, 1, 8, 2, 16, 4)
    with pytest.raises(ValueError, match="CUDA"):
        mamba_scan_bwd_kernel_call(x, dt, A, Bm, Cm, x)
    with pytest.raises(ValueError, match="shared memory"):
        (_, x), (_, dt), (_, A), (_, Bm), (_, Cm) = _mamba_inputs(
            R, 1, 300, 2, 8, 300)
        mamba_scan_bwd_kernel_call(x, dt, A, Bm, Cm, x)


@pytest.mark.parametrize("name,scale", B8_CONFIGS)
def test_scan_bwd_shared_memory_fits_every_config_reaching_b8(name, scale):
    """B8b's blocks fit a block's shared memory at every config that runs
    B8, and two of the chunk backward's fit an SM."""
    from repro_torch.kernels.mamba_scan import bwd_shared_bytes, check_bwd_shapes

    cfg = (configs.get if scale == "full" else configs.get_reduced)(name)
    check_bwd_shapes(cfg.ssd_chunk, _HEAD_P, cfg.ssm_state)
    need = bwd_shared_bytes(cfg.ssd_chunk, _HEAD_P, cfg.ssm_state)
    assert need <= MAX_SHARED_BYTES
    assert 2 * (need + BLOCK_RESERVED_BYTES) <= SM_SHARED_BYTES
    assert need == 78_336   # every such config has P = 64


@pytest.mark.parametrize("B,T,H,P,S,chunk,want", [
    (2, 4096, 64, 64, 64, 128, (32, 103_292_928)),   # zamba2-1.2b training
    (2, 1000, 8, 64, 16, 128, (8, 1_118_464)),
    (1, 37, 2, 8, 4, 128, (1, 18_196)),
])
def test_scan_bwd_scratch_shapes(B, T, H, P, S, chunk, want):
    """The backward's scratch: B8's own, the final state, the gradient of
    the state leaving each chunk, the per-head parts of dBm and dCm and the
    per-chunk parts of dA (about 0.4 GB at zamba2-1.2b's training shape,
    where the step recurrence's took 805 MB)."""
    from repro_torch.kernels.mamba_scan import bwd_scratch_shapes

    shapes = bwd_scratch_shapes(B, T, H, P, S, chunk)
    n_chunks, n_floats = want
    assert shapes[:5] == scan_scratch_shapes(B, T, H, P, S, min(chunk, T))
    assert shapes[5:] == ((B, H, P, S), (B, H, n_chunks, P, S), (B, H, T, S),
                          (B, H, T, S), (B, H, n_chunks))
    assert sum(int(np.prod(s)) for s in shapes) == n_floats
