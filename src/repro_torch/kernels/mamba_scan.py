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

The gradient (B8b, which no TPU kernel has: the reference trains through
XLA's autodiff of `chunked_ssd`) is `MambaScan`, a
`torch.autograd.Function` whose backward launches ``csrc/mamba_scan_bwd.cu``
(`mamba_scan_bwd_kernel_call`) on the card and runs `mamba_scan_bwd_plain`
on the CPU: dx, ddt, dA, dBm and dCm from dy and the final state's
gradient. Both work on B8's chunked form with the forward's chunk: B8's
first three passes again (the same bits: C B^T, each chunk's entering
state), then each chunk's share of the state gradient, the gradient of
the state leaving each chunk passed back over the chunks, and each
chunk's gradients from those, parallel over (chunk, head, batch). Sums
over the heads (dBm, dCm) and over the batch and chunks (dA) run in a
fixed order, with no atomics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_tensor, launch

__all__ = ["MAX_CHUNK", "MAX_SHARED_BYTES", "MambaScan", "bwd_scratch_shapes",
           "bwd_shared_bytes", "check_bwd_shapes", "chunked_ssd",
           "cumsum_in_order", "mamba_scan_bwd_kernel_call",
           "mamba_scan_bwd_plain", "mamba_scan_kernel_call", "mamba_scan_plain",
           "scan_scratch_shapes", "scan_shared_bytes"]

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
    flips bfloat16 roundings of y between the kernel and this version.
    On meta tensors (the census), which have no values to order, it is
    `torch.cumsum`: one op where the loop would be one a step."""
    if a.is_meta:
        return torch.cumsum(a, 1)
    out = torch.empty_like(a)
    run = a[:, 0]
    out[:, 0] = run
    for t in range(1, a.shape[1]):
        run = run + a[:, t]
        out[:, t] = run
    return out


def chunked_ssd(x, log_decay, scale, Bm, Cm, chunk: int = 128,
                entering: list | None = None):
    """The chunked SSD of `repro.models.ssm.chunked_ssd`, a copy but for
    the cumulative log decay, which accumulates in order
    (`cumsum_in_order`):

        h_t = exp(ld_t) h_{t-1} + s_t x_t ⊗ B_t ;  y_t = C_t · h_t

    x (B, T, H, P) values, log_decay and scale (B, T, H), Bm/Cm (B, T, G, S)
    keys and queries with G == 1 (shared) or H (per head). T must be a
    multiple of ``min(chunk, T)``, as the reference asserts. Returns (y in
    x's type, final state (B, H, P, S) float32); a list passed as
    `entering` receives the state entering each chunk."""
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
        if entering is not None:
            entering.append(h)
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


# the backward source's shared-memory layout (floats): its products are
# MAX_CHUNK rows (chunk steps) by 64 columns, their operands staged in
# strips of _BWD_STRIP steps of k, rows of 132 and 68 floats
_BWD_STRIP = 8
_LD_ROWS, _LD_COLS = MAX_CHUNK + 4, 64 + 4


def bwd_shared_bytes(chunk: int, P: int, S: int) -> int:
    """Dynamic shared memory of the backward's largest block, in bytes:
    the chunk backward holds N = E o (dy u^T) (MAX_CHUNK rows of
    MAX_CHUNK + 4 floats; once N is consumed, a (MAX_CHUNK, 64)-column
    result in rows of 68), two operand strips (_BWD_STRIP x 132 and
    _BWD_STRIP x 68 floats), eight vectors of MAX_CHUNK floats and one
    float per state row. `chunk` and S do not change it (S is staged 64
    columns at a time)."""
    strips = _BWD_STRIP * (_LD_ROWS + _LD_COLS)
    return 4 * (MAX_CHUNK * _LD_ROWS + strips + 8 * MAX_CHUNK
                + -(-P // 4) * 4)


def check_bwd_shapes(chunk: int, P: int, S: int) -> None:
    """Raise where B8b does not take (chunk, P, S): it recomputes B8's
    first three passes (`scan_shared_bytes`), so it takes what B8 takes,
    and its own blocks must fit (`bwd_shared_bytes`)."""
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the scan's backward takes at most "
                         f"{MAX_CHUNK}")
    need = max(scan_shared_bytes(chunk, P, S), bwd_shared_bytes(chunk, P, S))
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"chunk {chunk}, P {P}, S {S} need {need} bytes of "
                         f"shared memory, above the {MAX_SHARED_BYTES} a "
                         "block has")


def bwd_scratch_shapes(B: int, T: int, H: int, P: int, S: int,
                       chunk: int = 128) -> tuple[tuple, ...]:
    """The float32 scratch `mamba_scan_bwd_kernel_call` allocates: B8's
    own (`scan_scratch_shapes`: the state entering each chunk, each
    chunk's decay, C B^T, C^T and B), the final state (B, H, P, S), the
    gradient of the state leaving each chunk (B, H, n_chunks, P, S), the
    per-head parts of dBm and dCm (B, H, T, S) each, and of dA, one a
    chunk (B, H, n_chunks)."""
    c = max(1, min(chunk, T))
    n_chunks = -(-T // c)
    return (*scan_scratch_shapes(B, T, H, P, S, c), (B, H, P, S),
            (B, H, n_chunks, P, S), (B, H, T, S), (B, H, T, S),
            (B, H, n_chunks))


def _in_order_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis, one float32 addition a term, in order from
    zero: a thread's chain in the kernel."""
    acc = torch.zeros_like(t[..., 0])
    for j in range(t.shape[-1]):
        acc = acc + t[..., j]
    return acc


def _dot_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_j a[..., j] * b[..., j], each product rounded, then added in
    order from zero (the kernel's chains are not fused)."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape, b.shape)[:-1],
                      dtype=torch.float32, device=a.device)
    for j in range(a.shape[-1]):
        acc = acc + a[..., j] * b[..., j]
    return acc


def _bwd_chunked(x, dt, A, Bm, Cm, dy, dh_last, chunk: int):
    """The chunked backward on every chunk at once: (dx, ddt (B, T, H),
    per-chunk dA parts (B, n_chunks, H), per-head dBm and dCm parts
    (B, H, T, S)), float32 but dx. See `mamba_scan_bwd_plain`."""
    B, T, H, P, S = _shapes(x, dt, A, Bm, Cm)
    dev = x.device
    c = max(1, chunk)
    pad = (-T) % c
    nc = (T + pad) // c
    Af = A.float()
    dtf = F.pad(dt.float(), (0, 0, 0, pad))
    # B8's states: the one entering each chunk, and the final one
    entering = []
    _, h_final = chunked_ssd(F.pad(x, (0, 0, 0, 0, 0, pad)), dtf * Af, dtf,
                             F.pad(Bm, (0, 0, 0, pad))[:, :, None],
                             F.pad(Cm, (0, 0, 0, pad))[:, :, None], chunk=c,
                             entering=entering)
    hs = torch.stack(entering, 1)                                # (B,n,H,P,S)
    h_next = torch.cat([hs[:, 1:], h_final[:, None]], 1)

    def heads(t):   # (B, T, H, ...) padded -> (B, n, H, c, ...)
        t = F.pad(t.float(), (0, 0) * (t.ndim - 2) + (0, pad))
        return t.unflatten(1, (nc, c)).transpose(2, 3)

    xh, dyh, dth = heads(x), heads(dy), heads(dt)
    Bc = F.pad(Bm.float(), (0, 0, 0, pad)).unflatten(1, (nc, c))  # (B,n,c,S)
    Cc = F.pad(Cm.float(), (0, 0, 0, pad)).unflatten(1, (nc, c))
    Bch = Bc[:, :, None].expand(B, nc, H, c, S)
    Cch = Cc[:, :, None].expand(B, nc, H, c, S)
    L = cumsum_in_order((dtf * Af).reshape(B * nc, c, H))
    L = L.reshape(B, nc, c, H).transpose(2, 3)                    # (B,n,H,c)
    eL = torch.exp(L)
    W = torch.exp(L[..., -1:] - L)
    u = dth[..., None] * xh                                       # (B,n,H,c,P)
    CB = torch.einsum("bncs,bnks->bnck", Cc, Bc)[:, :, None]      # [t][tau]
    tril = torch.ones((c, c), dtype=torch.bool, device=dev).tril()
    decay = torch.exp(L[..., :, None] - L[..., None, :])
    E = torch.where(tril, decay, torch.zeros_like(decay))
    M = E * CB

    # the gradient of the state leaving each chunk, from the last
    term = torch.matmul((eL[..., None] * dyh).transpose(-1, -2), Cch)
    dec = torch.exp(L[..., -1])                                   # (B,n,H)
    G = (torch.zeros_like(h_final) if dh_last is None
         else dh_last.float().expand_as(h_final))
    Gs = [None] * nc
    for k in range(nc - 1, -1, -1):
        Gs[k] = G
        G = dec[:, k, :, None, None] * G + term[:, k]
    Gk = torch.stack(Gs, 1)                                       # (B,n,H,P,S)

    N = E * torch.matmul(dyh, u.transpose(-1, -2))    # E o (dy_t . u_tau)
    row_z = _in_order_sum(N * CB)
    ht_dy = torch.matmul(dyh, hs)                                 # (B,n,H,c,S)
    dC = torch.matmul(N, Bch) + eL[..., None] * ht_dy
    inter = eL * _dot_in_order(Cch, ht_dy)
    dB = (torch.matmul(N.transpose(-1, -2), Cch)
          + W[..., None] * torch.matmul(u, Gk))
    du = (torch.matmul(M.transpose(-1, -2), dyh)
          + W[..., None] * torch.matmul(Bch, Gk.transpose(-1, -2)))
    dxh = dth[..., None] * du
    x_du = _dot_in_order(xh, du)
    u_du = _dot_in_order(u, du)
    lam = _in_order_sum(_dot_in_order(Gk, h_next))                # (B,n,H)
    dL = (row_z + inter) - u_du
    da = torch.empty_like(dL)
    run, dA_part = lam, torch.zeros_like(lam)
    for j in range(c - 1, -1, -1):
        run = run + dL[..., j]
        da[..., j] = run
        dA_part = dA_part + run * dth[..., j]
    ddt = x_du + da * Af[:, None]

    def steps(t):   # (B, n, H, c, ...) -> (B, T, H, ...)
        return t.transpose(2, 3).flatten(1, 2)[:, :T]

    return (steps(dxh), steps(ddt), dA_part,
            dB.transpose(1, 2).flatten(2, 3)[:, :, :T],
            dC.transpose(1, 2).flatten(2, 3)[:, :, :T])


def mamba_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dh_last=None, *,
                         chunk: int = 128):
    """(dx (B, T, H, P) in x's type, ddt (B, T, H) float32, dA (H,)
    float32, dBm and dCm (B, T, S) in Bm's type): the gradient of the scan
    at (x, dt, A, Bm, Cm) given dy (B, T, H, P) and the final state's
    gradient dh_last (B, H, P, S) or None (zero). Runs on any device, in
    the kernel's float32 arithmetic, on B8's chunked form with B8's
    chunks. Per (batch, chunk, head), with L, u = dt o x, the decay mask E
    (exp(L_t - L_tau) where tau <= t, else 0), M = E o C B^T and
    W = exp(L_c - L) as B8 computes them, h the state entering the chunk
    (B8's bits) and G the gradient of the state leaving it:

        G_{k-1} = exp(L_c) G_k + (exp(L) o dy)^T C   (dh_last after the last)
        N  = E o (dy u^T)
        du = M^T dy + W o (B G^T),          dx = dt o du
        dC = N B + exp(L) o (dy h)          dB = N^T C + W o (u G)
        dL_t = (sum_tau N C B^T [t, tau] + exp(L_t) C_t . (dy h)_t)
               - u_t . du_t
        da = the reverse cumulative sum of dL from G_k . h_{k+1}
        ddt = x . du + da A,                dA += da dt

    Each product is one float32 GEMM (cuBLAS's on the card, which add
    each output's products in k order by FFMA, as the kernel's fmaf
    chains do) run as a batch of matrices; every row sum and dot product
    is added in order from zero (`_in_order_sum`, `_dot_in_order`), as
    the reverse cumulative sum (from the last step) and dA's steps. dBm
    and dCm add the heads in order, dA the batch, then the chunks, in
    order. As `mamba_scan_plain` does, a batch of one runs on the card as
    two equal sequences and T below the chunk as one padded chunk."""
    B, T, H, P, S = _shapes(x, dt, A, Bm, Cm)
    dev = x.device
    if B * T * H == 0:
        return (torch.zeros_like(x), torch.zeros((B, T, H), device=dev),
                torch.zeros((H,), device=dev), torch.zeros_like(Bm),
                torch.zeros_like(Cm))
    if B == 1 and x.is_cuda:
        def two(t):
            return None if t is None else t.expand(2, *t.shape[1:])

        parts = _bwd_chunked(two(x), two(dt), A, two(Bm), two(Cm), two(dy),
                             two(dh_last), chunk)
        parts = [t[:1] for t in parts]
    else:
        parts = _bwd_chunked(x, dt, A, Bm, Cm, dy, dh_last, chunk)
    dx, ddt, dA_part, dB_part, dC_part = parts
    dA = torch.zeros((H,), dtype=torch.float32, device=dev)
    for b in range(B):
        for k in range(dA_part.shape[1]):
            dA = dA + dA_part[b, k]
    dBm = torch.zeros((B, T, S), dtype=torch.float32, device=dev)
    dCm = torch.zeros_like(dBm)
    for hh in range(H):
        dBm = dBm + dB_part[:, hh]
        dCm = dCm + dC_part[:, hh]
    return (dx.to(x.dtype).contiguous(), ddt.contiguous(), dA,
            dBm.to(Bm.dtype), dCm.to(Cm.dtype))


def mamba_scan_bwd_kernel_call(x, dt, A, Bm, Cm, dy, dh_last=None, *,
                               chunk: int = 128):
    """Launch B8b on CUDA tensors: (dx, ddt, dA, dBm, dCm) as
    `mamba_scan_bwd_plain` returns them, at the forward's `chunk`.

    x, Bm, Cm and dy are contiguous and of one type (float32 or bfloat16);
    dt, A and dh_last (or None) are float32; (chunk, P, S) must be what
    B8 takes and the backward's blocks must fit (`check_bwd_shapes`).
    Anything else raises. Allocates the gradients and the scratch of
    `bwd_scratch_shapes`, launches on the current stream (B8's first three
    passes, then the backward's five) and does not synchronise."""
    B, T, H, P, S = _shapes(x, dt, A, Bm, Cm)
    c = max(1, min(chunk, T))
    check_bwd_shapes(c, P, S)
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype}: the kernel takes float32 or bfloat16")
    dev = x.device
    check_tensor("x", x, x.dtype, (B, T, H, P), dev)
    check_tensor("dt", dt, torch.float32, (B, T, H), dev)
    check_tensor("A", A, torch.float32, (H,), dev)
    check_tensor("Bm", Bm, x.dtype, (B, T, S), dev)
    check_tensor("Cm", Cm, x.dtype, (B, T, S), dev)
    check_tensor("dy", dy, x.dtype, (B, T, H, P), dev)
    if dh_last is not None:
        check_tensor("dh_last", dh_last, torch.float32, (B, H, P, S), dev)
    dx = torch.empty_like(x)
    ddt = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    dA = torch.empty((H,), dtype=torch.float32, device=dev)
    dBm, dCm = torch.empty_like(Bm), torch.empty_like(Cm)
    if B * T * H * P * S == 0:
        return dx.zero_(), ddt.zero_(), dA.zero_(), dBm.zero_(), dCm.zero_()
    scratch = [torch.empty(shape, dtype=torch.float32, device=dev)
               for shape in bwd_scratch_shapes(B, T, H, P, S, c)]
    bf16 = int(x.dtype == torch.bfloat16)
    states, decay, cb, ct, bt, h_last, *grads = (t.data_ptr() for t in scratch)
    launch("mamba_scan_states_launch", dev,
           x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
           Cm.data_ptr(), h_last, states, decay, cb, ct, bt, B, T, H, P, S, c,
           bf16)
    launch("mamba_scan_bwd_launch", dev,
           x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
           Cm.data_ptr(), dy.data_ptr(),
           dh_last.data_ptr() if dh_last is not None else None,
           dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(),
           dCm.data_ptr(), states, decay, cb, h_last, *grads, B, T, H, P, S,
           c, bf16)
    mamba_scan_bwd_kernel_call.launches += 1
    return dx, ddt, dA, dBm, dCm


mamba_scan_bwd_kernel_call.launches = 0


class MambaScan(torch.autograd.Function):
    """B8 with its gradient: the forward is B8 (or its plain version), the
    backward B8b (or its plain version); ``plain`` picks the plain pair,
    which a CPU tensor always takes. Returns (y, final state); both may
    carry a gradient."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk: int, plain: bool):
        fwd = mamba_scan_plain if plain else mamba_scan_kernel_call
        y, h_last = fwd(x, dt, A, Bm, Cm, chunk=chunk)
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk, ctx.plain = chunk, plain
        ctx.set_materialize_grads(False)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        bwd = mamba_scan_bwd_plain if ctx.plain else mamba_scan_bwd_kernel_call
        dx, ddt, dA, dBm, dCm = bwd(
            x, dt, A, Bm, Cm, dy.to(x.dtype).contiguous(),
            None if dh_last is None else dh_last.float().contiguous(),
            chunk=ctx.chunk)
        return dx, ddt, dA, dBm, dCm, None, None

