"""The chunked Mamba-2 / SSD scan: the CUDA kernel B8 and its plain version.

Port of `repro.kernels.mamba_scan`. With L the cumulative log decay
``cumsum(dt * A)`` inside a chunk of c steps, per (batch, head):

    y  = (tril(exp(L_t - L_tau)) o (C B^T)) @ (dt o x) + exp(L) o (C h^T)
    h <- exp(L_c) h + ((dt o x) o exp(L_c - L_tau))^T @ B

with the (P, S) state h carried over chunks in float32. Unlike the TPU
kernel, both versions take any T (a ragged last chunk acts as the
reference's zero padding: dt = 0, so decay 1 and no input) and return the
final state beside y, which `repro_torch.models.ssm.mamba2_forward` needs.

`mamba_scan_kernel_call` launches ``csrc/mamba_scan.cu`` (see the source
note): a pass for each chunk's C B^T, a chunk-state pass, a state pass
over the chunks in order and a chunk-scan pass, with a float32 scratch
(`scan_scratch_shapes`) allocated here; `mamba_scan_plain` computes the same
function with torch ops through
`chunked_ssd`, the model-side chunked form (a copy of the reference's, which
`repro_torch.models.ssm` re-exports), chunk by chunk, vectorised over batch
and heads. `repro_torch.kernels.ops.mamba_scan` picks between them by the
device of `x`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_tensor, launch

__all__ = ["MAX_CHUNK", "MAX_SHARED_BYTES", "chunked_ssd", "cumsum_in_order",
           "mamba_scan_kernel_call", "mamba_scan_plain", "scan_scratch_shapes",
           "scan_shared_bytes"]

MAX_SHARED_BYTES = 232_448   # the H100's shared memory per block
MAX_CHUNK = 128              # kMaxChunk in the source
_DTYPES = (torch.float32, torch.bfloat16)
# the source's shared-memory layout (floats): kStrip, kGroupP and the row
# lengths of its transposed arrays
_STRIP, _GROUP_P = 32, 64
_LD_T, _LD_STRIP, _LD_P = MAX_CHUNK + 4, _STRIP + 4, _GROUP_P + 4


def _shapes(x, dt, A, Bm, Cm):
    if x.ndim != 4:
        raise ValueError(f"expected x (B, T, H, P), got {tuple(x.shape)}")
    B, T, H, P = x.shape
    S = Bm.shape[-1] if Bm.ndim == 3 else -1
    if (tuple(dt.shape) != (B, T, H) or tuple(A.shape) != (H,)
            or tuple(Bm.shape) != (B, T, S) or tuple(Cm.shape) != (B, T, S)):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, Bm {tuple(Bm.shape)}, Cm "
                         f"{tuple(Cm.shape)}: expected dt (B, T, H), A (H,), "
                         "Bm and Cm (B, T, S)")
    return B, T, H, P, S


def scan_shared_bytes(chunk: int, P: int, S: int) -> int:
    """Dynamic shared memory of the kernel's largest block, in bytes: the
    C B^T pass holds 32 rows of C and up to 128 of B, transposed; the
    chunk-state pass a chunk's dt o x and B (rows padded to 4 floats); the
    chunk-scan pass C transposed, a strip's dt o x (32 steps x 64 columns),
    two strips of M transposed and the entering state's 64 columns
    transposed. The last two hold dt, L and one more row of MAX_CHUNK
    floats."""
    def r4(v):
        return -(-v // 4) * 4
    cb = S * _LD_STRIP + S * _LD_T
    state = 3 * MAX_CHUNK + chunk * (r4(P) + r4(S))
    scan = (3 * MAX_CHUNK + S * _LD_T + _STRIP * _GROUP_P + 2 * _STRIP * _LD_T
            + S * _LD_P)
    return 4 * max(cb, state, scan)


def scan_scratch_shapes(B: int, T: int, H: int, P: int, S: int,
                        chunk: int = 128) -> tuple[tuple, ...]:
    """The float32 scratch the kernel call allocates: every chunk's state
    (B, H, n_chunks, P, S), first its own update, then the state entering
    it; every chunk's decay exp(L_c) (B, H, n_chunks); and, shared by the
    heads, every chunk's C B^T (B, n_chunks, MAX_CHUNK, MAX_CHUNK), C
    transposed (B, n_chunks, S, MAX_CHUNK) and B in float32, rows padded
    to 4 floats (B, n_chunks, MAX_CHUNK, S4)."""
    c = max(1, min(chunk, T))
    n_chunks = -(-T // c)
    return ((B, H, n_chunks, P, S), (B, H, n_chunks),
            (B, n_chunks, MAX_CHUNK, MAX_CHUNK), (B, n_chunks, S, MAX_CHUNK),
            (B, n_chunks, MAX_CHUNK, -(-S // 4) * 4))


def cumsum_in_order(a: torch.Tensor) -> torch.Tensor:
    """Cumulative sum along dim 1, one float32 addition per step in order,
    as the kernel accumulates L. `torch.cumsum` accumulates in double on
    the CPU and in a parallel scan on the card; with |L| up to ~100 inside
    a chunk, another association moves ``exp(L_t - L_tau)`` by ~1e-5, which
    flips bfloat16 roundings of y between the kernel and this version."""
    out = torch.empty_like(a)
    run = a[:, 0]
    out[:, 0] = run
    for t in range(1, a.shape[1]):
        run = run + a[:, t]
        out[:, t] = run
    return out


def chunked_ssd(x, log_decay, scale, Bm, Cm, chunk: int = 128):
    """The chunked SSD of `repro.models.ssm.chunked_ssd`, a copy but for
    the cumulative log decay, which accumulates in order
    (`cumsum_in_order`):

        h_t = exp(ld_t) h_{t-1} + s_t x_t ⊗ B_t ;  y_t = C_t · h_t

    x (B, T, H, P) values, log_decay and scale (B, T, H), Bm/Cm (B, T, G, S)
    keys and queries with G == 1 (shared) or H (per head). T must be a
    multiple of ``min(chunk, T)``, as the reference asserts. Returns (y in
    x's type, final state (B, H, P, S) float32)."""
    B, T, H, P = x.shape
    G, S = Bm.shape[2], Bm.shape[3]
    c = min(chunk, T)
    if T % c:
        raise ValueError(f"T = {T} is not a multiple of the chunk {c}")
    nc = T // c
    xr = x.reshape(B, nc, c, H, P)
    ldr = log_decay.reshape(B, nc, c, H).float()
    sr = scale.reshape(B, nc, c, H).float()
    Br = Bm.reshape(B, nc, c, G, S).float()
    Cr = Cm.reshape(B, nc, c, G, S).float()
    tril = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((B, H, P, S), dtype=torch.float32, device=x.device)
    ys = []
    for i in range(nc):
        xc, ldc, sc, bc, cc = xr[:, i], ldr[:, i], sr[:, i], Br[:, i], Cr[:, i]
        L = cumsum_in_order(ldc)                                    # (B,c,H)
        # intra-chunk
        CB = torch.einsum("bcgs,bkgs->bckg", cc, bc)                # (B,c,c,G)
        decay = torch.exp(L[:, :, None, :] - L[:, None, :, :])      # (B,c,c,H)
        gmat = torch.where(tril[None, :, :, None], decay, torch.zeros_like(decay))
        attn = gmat * CB                                            # (B,c,c,H)
        dx = sc[..., None] * xc.float()                             # (B,c,H,P)
        y_intra = torch.einsum("bckh,bkhp->bchp", attn, dx)
        # inter-chunk, from the carried state h (B,H,P,S)
        if G == 1:
            y_inter = torch.einsum("bcs,bhps->bchp", cc[:, :, 0], h)
        else:
            y_inter = torch.einsum("bchs,bhps->bchp", cc, h)
        ys.append(y_intra + torch.exp(L)[..., None] * y_inter)
        # state update
        w = torch.exp(L[:, -1:, :] - L)[..., None] * dx             # (B,c,H,P)
        if G == 1:
            dh = torch.einsum("bkhp,bks->bhps", w, bc[:, :, 0])
        else:
            dh = torch.einsum("bkhp,bkhs->bhps", w, bc)
        h = torch.exp(L[:, -1])[..., None, None] * h + dh
    y = torch.stack(ys, dim=1).reshape(B, T, H, P)
    return y.to(x.dtype), h


def mamba_scan_plain(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """(y (B, T, H, P) in x's type, final state (B, H, P, S) float32);
    runs on any device. `chunked_ssd` with one shared group, log decay
    ``dt * A`` and scale ``dt``, after zero-padding T to a chunk multiple.

    On the card its products are cuBLAS's float32 GEMMs, which add each
    output's products in k order by FFMA, as the kernel's fmaf chains do,
    when they run as a batch of matrices: a single GEMM (batch one) of
    some shapes is split along k (cublasLt's split-K) and its parts added,
    and one of a row or a column is a GEMV, whose sums are trees. So a
    batch of one runs here as a batch of two equal sequences, and a T
    below the chunk as one chunk of the full length, zero-padded: the same
    values, since the padded steps add no term and keep L (dt = 0)."""
    B, T, H, P, S = _shapes(x, dt, A, Bm, Cm)
    if B == 1 and x.is_cuda:
        y, h = mamba_scan_plain(*(t.expand(2, *t.shape[1:]) for t in (x, dt)),
                                A, *(t.expand(2, *t.shape[1:]) for t in (Bm, Cm)),
                                chunk=chunk)
        return y[:1], h[:1]
    c = max(1, chunk)
    pad = (-T) % c
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    y, h = chunked_ssd(F.pad(x, (0, 0, 0, 0, 0, pad)), dtf * A.float(), dtf,
                       F.pad(Bm, (0, 0, 0, pad))[:, :, None],
                       F.pad(Cm, (0, 0, 0, pad))[:, :, None], chunk=c)
    return y[:, :T], h


def mamba_scan_kernel_call(x, dt, A, Bm, Cm, *, chunk: int = 128):
    """Launch the B8 CUDA kernel on CUDA tensors; returns (y (B, T, H, P) in
    x's type, final state (B, H, P, S) float32).

    x, Bm and Cm are contiguous and of one type (float32 or bfloat16); dt
    and A are float32. The chunk is at most MAX_CHUNK steps and the working
    set must fit in a block's shared memory (`scan_shared_bytes`). Anything
    else raises. Allocates the outputs and the scratch of
    `scan_scratch_shapes`, launches on the current stream, reads nothing
    back and does not synchronise, so a CUDA graph can capture it.
    """
    B, T, H, P, S = _shapes(x, dt, A, Bm, Cm)
    c = max(1, min(chunk, T))
    if c > MAX_CHUNK:
        raise ValueError(f"chunk {c}: the kernel takes at most {MAX_CHUNK}")
    if scan_shared_bytes(c, P, S) > MAX_SHARED_BYTES:
        raise ValueError(f"chunk {c}, P {P}, S {S} need "
                         f"{scan_shared_bytes(c, P, S)} bytes of shared "
                         f"memory, above the {MAX_SHARED_BYTES} a block has")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype}: the kernel takes float32 or bfloat16")
    dev = x.device
    check_tensor("x", x, x.dtype, (B, T, H, P), dev)
    check_tensor("dt", dt, torch.float32, (B, T, H), dev)
    check_tensor("A", A, torch.float32, (H,), dev)
    check_tensor("Bm", Bm, x.dtype, (B, T, S), dev)
    check_tensor("Cm", Cm, x.dtype, (B, T, S), dev)
    y = torch.empty_like(x)
    if B * H * T * P * S == 0:   # no step: the state stays at zero
        return y, torch.zeros((B, H, P, S), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, H, P, S), dtype=torch.float32, device=dev)
    scratch = [torch.empty(shape, dtype=torch.float32, device=dev)
               for shape in scan_scratch_shapes(B, T, H, P, S, c)]
    launch("mamba_scan_launch", dev,
           x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
           Cm.data_ptr(), y.data_ptr(), h_last.data_ptr(),
           *(t.data_ptr() for t in scratch), B, T, H, P, S, c,
           int(x.dtype == torch.bfloat16))
    mamba_scan_kernel_call.launches += 1
    return y, h_last


mamba_scan_kernel_call.launches = 0
