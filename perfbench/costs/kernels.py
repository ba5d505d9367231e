"""The operations and bytes of one call of each of the port's LM kernels,
in closed form, frozen here so that a change to a kernel cannot change
its yardstick. Bytes count each input read once and each output written
once; operations count two per multiply-add of the products the
algorithm needs (for B7, of the valid positions only).

* B6, flash attention forward: 4 D per attended (query, key) pair and
  query head; q, k, v read, the output written.
* B6b, its backward: five products of depth D per pair (S, dP, dQ, dK,
  dV): 10 D; q, O, dO, dQ and k, v, dK, dV.
* B7, decode attention: 4 D per valid cached position and query head;
  q and the output, the valid rows of K and V, the lengths.
* B8, the chunked selective scan: per chunk of c and head, C B^T and
  (L o C B^T) x over the chunk's lower triangle and the states B^T x and
  C h (c P S each): 2 S tri + 2 P tri + 4 c P S; x and y, dt, A, B, C and
  the final state.
* B8b, its backward: twice B8's products; x, dy and dx, dt and ddt, A and
  dA, B, C, dB and dC.
"""
from __future__ import annotations

__all__ = ["b6", "b6b", "b7", "b8", "b8b", "causal_pairs"]


def causal_pairs(Tq: int, Tk: int) -> int:
    """(query, key) pairs of one head under a causal mask whose last query
    sees every key (query i sees keys up to i + Tk - Tq)."""
    return sum(max(0, min(Tk, i + Tk - Tq + 1)) for i in range(Tq)) \
        if Tq != Tk else Tq * (Tq + 1) // 2


def b6(B, Hq, Hkv, Tq, Tk, D, causal=True, elt=2) -> tuple[int, int]:
    pairs = causal_pairs(Tq, Tk) if causal else Tq * Tk
    q, kv = B * Hq * Tq * D, B * Hkv * Tk * D
    return 4 * D * pairs * B * Hq, elt * (2 * q + 2 * kv)


def b6b(B, Hq, Hkv, T, D, elt=2) -> tuple[int, int]:
    pairs = T * (T + 1) // 2
    q, kv = B * Hq * T * D, B * Hkv * T * D
    return 10 * D * pairs * B * Hq, elt * (4 * q + 4 * kv)


def b7(B, Hq, Hkv, D, n_valid, elt=2) -> tuple[int, int]:
    """`n_valid`: the valid positions summed over the B rows."""
    return 4 * D * Hq * n_valid, \
        elt * (2 * B * Hq * D + 2 * n_valid * Hkv * D) + 4 * B


def _scan_ops(B, T, H, P, S, chunk) -> int:
    tri = chunk * (chunk + 1) // 2
    return B * H * -(-T // chunk) * (tri * 2 * S + tri * 2 * P
                                     + 4 * chunk * P * S)


def b8(B, T, H, P, S, chunk=128, elt=2) -> tuple[int, int]:
    x, bc = B * T * H * P, B * T * S
    return _scan_ops(B, T, H, P, S, chunk), \
        2 * elt * x + 4 * B * T * H + 4 * H + 2 * elt * bc + 4 * B * H * P * S


def b8b(B, T, H, P, S, chunk=128, elt=2) -> tuple[int, int]:
    x, bc = B * T * H * P, B * T * S
    return 2 * _scan_ops(B, T, H, P, S, chunk), \
        3 * elt * x + 8 * B * T * H + 8 * H + 4 * elt * bc
