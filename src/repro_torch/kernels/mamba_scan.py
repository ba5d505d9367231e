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
gradient. It works on the step recurrence, which computes the same
function as the chunked form, row by row of the state (each of a head's P
rows is its own recurrence over the S columns): the states are recomputed
from the inputs (a forward pass keeps one every `BWD_SEGMENT` steps, each
segment is recomputed from it in reverse), not taken from the forward's
chunk scratch, whose states come from the chunked form's other roundings.
Sums over a head's rows, over the heads (dBm, dCm) and over the batch and
steps (dA) run in a fixed order, with no atomics.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ._build import check_tensor, launch

__all__ = ["BWD_SEGMENT", "MAX_CHUNK", "MAX_SHARED_BYTES", "MambaScan",
           "bwd_scratch_shapes", "check_bwd_shapes", "chunked_ssd",
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


BWD_SEGMENT = 16    # steps a checkpoint covers, kSeg in the backward source
_BWD_ROWS = 16      # state rows a pass of the backward's block holds
_BWD_MAX_P = 64     # 4 passes: kMaxPasses x kWarps in the source
_BWD_MAX_S = 64     # two state columns a lane


def check_bwd_shapes(P: int, S: int) -> None:
    """Raise where the backward kernel does not take (P, S): P a multiple
    of 16 up to 64, S up to 64 (Mamba-2's heads have P = 64)."""
    if P % _BWD_ROWS or not 0 < P <= _BWD_MAX_P or not 0 < S <= _BWD_MAX_S:
        raise ValueError(f"P {P}, S {S}: the scan's backward takes P a "
                         f"multiple of {_BWD_ROWS} up to {_BWD_MAX_P} and S "
                         f"up to {_BWD_MAX_S}")


def _s_pad(S: int) -> int:
    return 32 if S <= 32 else 64


def bwd_scratch_shapes(B: int, T: int, H: int, P: int, S: int):
    """The float32 scratch `mamba_scan_bwd_kernel_call` allocates: the
    checkpoints (B, H, n_segments, P, Sp), the per-head parts of dBm and
    dCm (B, H, T, Sp) each, and of dA (B, H); Sp is S padded to 32 or 64
    (a lane's columns)."""
    Sp = _s_pad(S)
    n_seg = -(-T // BWD_SEGMENT)
    return ((B, H, n_seg, P, Sp), (B, H, T, Sp), (B, H, T, Sp), (B, H))


def _lane_sum_s(t: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (S padded to 32 or 64) in the kernel's order:
    each lane's columns s and s + 32, then the xor butterfly over 32
    lanes."""
    x = t[..., :32] + t[..., 32:] if t.shape[-1] == 64 else t
    for w in (16, 8, 4, 2, 1):
        x = x[..., :w] + x[..., w:2 * w]
    return x[..., 0]


def _row_sum(c: torch.Tensor) -> torch.Tensor:
    """Sum over dim 2 (a head's P rows) in the kernel's order: each group
    of 16 rows halved (rows r and r + 8, then + 4, + 2, + 1), the groups
    added in order from zero."""
    y = c.unflatten(2, (c.shape[2] // _BWD_ROWS, _BWD_ROWS))
    for w in (8, 4, 2, 1):
        y = y[:, :, :, :w] + y[:, :, :, w:2 * w]
    y = y[:, :, :, 0]
    acc = torch.zeros_like(y[:, :, 0])
    for i in range(y.shape[2]):
        acc = acc + y[:, :, i]
    return acc


def mamba_scan_bwd_plain(x, dt, A, Bm, Cm, dy, dh_last=None):
    """(dx (B, T, H, P) in x's type, ddt (B, T, H) float32, dA (H,)
    float32, dBm and dCm (B, T, S) in Bm's type): the gradient of the scan
    at (x, dt, A, Bm, Cm) given dy (B, T, H, P) and the final state's
    gradient dh_last (B, H, P, S) or None (zero). Runs on any device, in
    the kernel's float32 arithmetic, on the step recurrence per state row:

        h_t = exp(dt_t A) h_{t-1} + (dt_t x_t) B_t,   y_t = h_t C_t

    Forward, every state (the kernel keeps one per `BWD_SEGMENT` steps and
    recomputes the rest, the same bits). Then from t = T - 1 down, with gc
    the gradient reaching h_t from later steps (dh_last at the end): g =
    gc + dy_t C_t; dC_t += dy_t h_t and dB_t += g (dt_t x_t) summed over
    the rows (`_row_sum`); dX = g . B_t per row (`_lane_sum_s`), dx_t = dX
    dt_t; da = sum over rows of g . (exp(dt_t A) h_{t-1}); ddt_t = sum over
    rows of x_t dX, plus da A; dA += da dt_t (steps in reverse order, then
    the batch in order); gc = exp(dt_t A) g. dBm and dCm add the heads in
    order."""
    B, T, H, P, S = _shapes(x, dt, A, Bm, Cm)
    check_bwd_shapes(P, S)
    Sp = _s_pad(S)
    dev = x.device
    xf, dyf, dtf, Af = x.float(), dy.float(), dt.float(), A.float()
    Bf = F.pad(Bm.float(), (0, Sp - S))
    Cf = F.pad(Cm.float(), (0, Sp - S))
    h = torch.zeros((B, H, P, Sp), dtype=torch.float32, device=dev)
    states, decays, us = [h], [], []
    for t in range(T):
        decay = torch.exp(dtf[:, t] * Af)                     # (B, H)
        u = dtf[:, t, :, None] * xf[:, t]                     # (B, H, P)
        h = decay[..., None, None] * h + u[..., None] * Bf[:, t, None, None, :]
        states.append(h)
        decays.append(decay)
        us.append(u)
    gc = (torch.zeros_like(h) if dh_last is None
          else F.pad(dh_last.float(), (0, Sp - S)))
    dA_acc = torch.zeros((B, H), dtype=torch.float32, device=dev)
    dx = torch.empty((B, T, H, P), dtype=torch.float32, device=dev)
    ddt = torch.empty((B, T, H), dtype=torch.float32, device=dev)
    dB_part = torch.empty((B, H, T, Sp), dtype=torch.float32, device=dev)
    dC_part = torch.empty_like(dB_part)
    for t in range(T - 1, -1, -1):
        decay, u = decays[t], us[t]
        g = gc + dyf[:, t, :, :, None] * Cf[:, t, None, None, :]
        dC_part[:, :, t] = _row_sum(dyf[:, t, :, :, None] * states[t + 1])
        dB_part[:, :, t] = _row_sum(g * u[..., None])
        dX = _lane_sum_s(g * Bf[:, t, None, None, :])           # (B, H, P)
        dx[:, t] = dX * dtf[:, t, :, None]
        q = decay[..., None, None] * states[t]
        da = _row_sum(_lane_sum_s(g * q)[..., None])[..., 0]    # (B, H)
        xdX = _row_sum((xf[:, t] * dX)[..., None])[..., 0]
        ddt[:, t] = xdX + da * Af
        dA_acc = dA_acc + da * dtf[:, t]
        gc = decay[..., None, None] * g
    dA = torch.zeros((H,), dtype=torch.float32, device=dev)
    for b in range(B):
        dA = dA + dA_acc[b]
    dBm = torch.zeros((B, T, Sp), dtype=torch.float32, device=dev)
    dCm = torch.zeros_like(dBm)
    for hh in range(H):
        dBm = dBm + dB_part[:, hh]
        dCm = dCm + dC_part[:, hh]
    return (dx.to(x.dtype), ddt, dA, dBm[..., :S].to(Bm.dtype).contiguous(),
            dCm[..., :S].to(Cm.dtype).contiguous())


def mamba_scan_bwd_kernel_call(x, dt, A, Bm, Cm, dy, dh_last=None):
    """Launch B8b on CUDA tensors: (dx, ddt, dA, dBm, dCm) as
    `mamba_scan_bwd_plain` returns them.

    x, Bm, Cm and dy are contiguous and of one type (float32 or bfloat16);
    dt, A and dh_last (or None) are float32; P is a multiple of 16 up to
    64 and S at most 64 (`check_bwd_shapes`). Anything else raises.
    Allocates the gradients and the scratch of `bwd_scratch_shapes`,
    launches on the current stream and does not synchronise."""
    B, T, H, P, S = _shapes(x, dt, A, Bm, Cm)
    check_bwd_shapes(P, S)
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
    if B * T * H == 0:
        return dx.zero_(), ddt.zero_(), dA.zero_(), dBm.zero_(), dCm.zero_()
    scratch = [torch.empty(shape, dtype=torch.float32, device=dev)
               for shape in bwd_scratch_shapes(B, T, H, P, S)]
    launch("mamba_scan_bwd_launch", dev,
           x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
           Cm.data_ptr(), dy.data_ptr(),
           dh_last.data_ptr() if dh_last is not None else None,
           dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dBm.data_ptr(),
           dCm.data_ptr(), *(t.data_ptr() for t in scratch),
           B, T, H, P, S, int(x.dtype == torch.bfloat16))
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
        ctx.plain = plain
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
            None if dh_last is None else dh_last.float().contiguous())
        return dx, ddt, dA, dBm, dCm, None, None

