"""Peaks of one NVIDIA H100 SXM and the least time of each kernel's work.

The arithmetic is the smoke script's (``gf_apply_bound``), copied so that
the yardstick lives with the benchmark: bytes read once and written once
at the HBM rate, or operations at the published peak, whichever is longer.
Work is counted from the shapes of each launch, so it is the same work
whatever implements it.
"""

from __future__ import annotations

#: HBM3 bytes/s (NVIDIA's data sheet, SXM part, 700 W)
HBM_BYTES_PER_S = 3.35e12
#: dense int8 tensor ops/s (data sheet)
INT8_TENSOR_OPS_PER_S = 1979e12
#: the sheet gives no b1 rate; a b1 mma takes k = 256 where int8 takes
#: k = 32 at the same issue rate, so eight times the int8 rate
B1_TENSOR_OPS_PER_S = 8 * INT8_TENSOR_OPS_PER_S
#: boost clock, and 64 int32 lanes per SM on 132 SMs
SM_CLOCK_HZ = 1.98e9
INT32_OPS_PER_S = 132 * 64 * SM_CLOCK_HZ

#: a lower bound on the 32-bit integer operations of one SHA-256
#: compression: 64 rounds of Sigma0 and Sigma1 (three rotates and a
#: three-input XOR each), Ch and Maj (one LOP3 each) and four adds (the
#: five-term T1 as two IADD3 with K as an immediate, e = d + T1, and
#: a = T1 + Sigma0 + Maj as one IADD3), then 48 schedule words of sigma0
#: and sigma1 (three shifts and a LOP3 each) and a four-term sum (two
#: IADD3), and the eight adds into the state
SHA256_OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8


def gf_apply_bound_s(n: int, k: int, r: int, s: int) -> float:
    """K1's least seconds for ``[n, k, s] -> [n, r, s]``: the input read
    and the output written once at the HBM rate, or the 0/1 bit-matrix
    product's ``(8r) x (8k)`` MACs per column on the b1 tensor cores,
    whichever is longer."""
    t_bytes = n * (k + r) * s / HBM_BYTES_PER_S
    t_ops = 2 * (8 * r) * (8 * k) * n * s / B1_TENSOR_OPS_PER_S
    return max(t_bytes, t_ops)


def sha256_blocks(length: int) -> int:
    """64-byte blocks SHA-256 compresses for a message of ``length``."""
    return (length + 8) // 64 + 1


def sha256_rows_bound_s(rows: int, s: int) -> float:
    """The SHA kernel's least seconds for ``rows`` rows of ``s`` bytes:
    each row read once and 32 bytes written, or every compression's
    operations on every int32 lane, whichever is longer."""
    t_bytes = rows * (s + 32) / HBM_BYTES_PER_S
    t_ops = rows * sha256_blocks(s) * SHA256_OPS_PER_BLOCK / INT32_OPS_PER_S
    return max(t_bytes, t_ops)
