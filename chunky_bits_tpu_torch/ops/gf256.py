"""GF(2^8) arithmetic core.

Field: GF(2^8) with the reducing polynomial x^8 + x^4 + x^3 + x^2 + 1
(0x11d) and generator 2 — the exact field used by the reference's erasure
codec, the ``reed-solomon-erasure`` crate's ``galois_8::Field`` (reference:
Cargo.toml:21; used at src/file/file_part.rs:77,161,302), which is itself the
Backblaze JavaReedSolomon convention.  Shard-level byte-identity with the
reference depends on this module being exactly that field.

Everything here is plain numpy on the host: tables are tiny (≤64 KiB) and the
hot batched codec paths live in the backends (ops/backend.py,
ops/cuda_backend.py), not here.  A copy of ``chunky_bits_tpu/ops/gf256.py``;
tests/test_torch_gf.py holds the two equal.
"""

from __future__ import annotations

import numpy as np

GF_POLY = 0x11D
GF_GEN = 2
ORDER = 255


def _build_tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(ORDER):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    # exp is periodic with period 255; extend so exp[log a + log b] never wraps
    for i in range(ORDER, 512):
        exp[i] = exp[i - ORDER]
    log[0] = -1  # log(0) is undefined; sentinel
    return exp, log


EXP_TABLE, LOG_TABLE = _build_tables()

# MUL_TABLE[a, b] = a ⊗ b over GF(2^8); 64 KiB, used to derive per-coefficient
# lookup rows for the numpy codec and the CUDA kernel's coefficient tables.
_a = np.arange(256, dtype=np.int32)
_la = LOG_TABLE[_a][:, None]
_lb = LOG_TABLE[_a][None, :]
MUL_TABLE = EXP_TABLE[(_la + _lb) % ORDER].astype(np.uint8)
MUL_TABLE[0, :] = 0
MUL_TABLE[:, 0] = 0
del _a, _la, _lb


def gf_mul(a: int, b: int) -> int:
    return int(MUL_TABLE[a, b])


def gf_div(a: int, b: int) -> int:
    if b == 0:
        raise ZeroDivisionError("GF(2^8) division by zero")
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] - LOG_TABLE[b]) % ORDER])


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("GF(2^8) inverse of zero")
    return int(EXP_TABLE[(ORDER - LOG_TABLE[a]) % ORDER])


def gf_pow(a: int, n: int) -> int:
    """a^n with the Backblaze ``galois.exp`` convention: a^0 == 1, 0^n == 0
    for n > 0.  This is what the reference's Vandermonde builder relies on."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP_TABLE[(LOG_TABLE[a] * n) % ORDER])


def gf_mul_bytes(c: int, data: np.ndarray) -> np.ndarray:
    """Multiply every byte of ``data`` by the constant ``c`` (vectorized)."""
    return MUL_TABLE[c][data]


def mul_bit_matrix(c: int) -> np.ndarray:
    """The 8x8 GF(2) matrix of 'multiply by constant c'.

    GF(2^8) is an 8-dimensional vector space over GF(2); multiplication by a
    constant is linear, so ``bits(c ⊗ x) = M_c @ bits(x) (mod 2)`` where
    column j of M_c holds ``bits(c ⊗ 2^j)``.  This is the bridge that turns
    the reference's byte-wise GF codec (src/file/file_part.rs:161) into plain
    binary products; the CUDA kernel's per-coefficient table holds exactly
    these columns (ops/gf_kernel.py).

    Returns uint8 [8, 8]; row k, col j = bit k of c ⊗ 2^j. Bit 0 is the LSB.
    """
    m = np.zeros((8, 8), dtype=np.uint8)
    for j in range(8):
        prod = gf_mul(c, 1 << j)
        for k in range(8):
            m[k, j] = (prod >> k) & 1
    return m


def expand_to_bit_matrix(mat: np.ndarray) -> np.ndarray:
    """Expand a GF(2^8) matrix [r, c] into its GF(2) bit-matrix [r*8, c*8].

    Block (i, j) is ``mul_bit_matrix(mat[i, j])``, so for byte vectors x,
    ``bits(mat ⊗ x) = expand_to_bit_matrix(mat) @ bits(x) (mod 2)``.
    """
    r, c = mat.shape
    out = np.zeros((r * 8, c * 8), dtype=np.uint8)
    for i in range(r):
        for j in range(c):
            out[i * 8:(i + 1) * 8, j * 8:(j + 1) * 8] = mul_bit_matrix(
                int(mat[i, j])
            )
    return out
