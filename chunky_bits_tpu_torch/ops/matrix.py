"""GF(2^8) matrix algebra and the Reed-Solomon matrix convention.

The port's own copy of ``chunky_bits_tpu/ops/matrix.py``;
tests/test_torch_gf.py holds the two equal over a (d, p) grid.

The encode matrix must match the reference's ``reed-solomon-erasure`` crate
(the Backblaze JavaReedSolomon construction) so that parity shards are
byte-identical with the reference (reference: src/file/file_part.rs:77 —
``ReedSolomon::new(d, p)``):

    V = vandermonde(d + p, d)      with V[r, c] = r^c  (GF power)
    E = V @ inv(V[:d])             (systematic: E[:d] == I)

Parity rows are ``E[d:]``; reconstruction inverts the d surviving rows.

Externally anchored (tests/test_matrix_conformance.py): the published
Backblaze 4+2 coding matrix, the QR-standard (ISO/IEC 18004) antilog
table for 0x11D/generator-2, and a from-scratch independent
implementation sharing no code with this module, equality-checked over a
(d, p) grid — a convention bug here is detectable without trusting this
derivation.
"""

from __future__ import annotations

import numpy as np

from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import gf256


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Matrix product over GF(2^8): XOR-accumulated table multiplies."""
    r, k = a.shape
    k2, c = b.shape
    assert k == k2
    out = np.zeros((r, c), dtype=np.uint8)
    for i in range(k):
        # out ^= a[:, i] ⊗ b[i, :] (outer product over GF)
        out ^= gf256.MUL_TABLE[a[:, i][:, None], b[i, :][None, :]]
    return out


def gf_identity(n: int) -> np.ndarray:
    return np.eye(n, dtype=np.uint8)


def gf_invert(mat: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^8).

    Raises ErasureError on singular matrices (the reference's
    ``Error::TooFewShardsPresent`` analogue surfaces above this).
    """
    n, m = mat.shape
    if n != m:
        raise ErasureError("cannot invert a non-square matrix")
    work = np.concatenate([mat.astype(np.uint8), gf_identity(n)], axis=1)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if work[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise ErasureError("singular matrix over GF(2^8)")
        if pivot != col:
            work[[col, pivot]] = work[[pivot, col]]
        inv_p = gf256.gf_inv(int(work[col, col]))
        work[col] = gf256.MUL_TABLE[inv_p][work[col]]
        for row in range(n):
            if row != col and work[row, col] != 0:
                factor = int(work[row, col])
                work[row] ^= gf256.MUL_TABLE[factor][work[col]]
    return work[:, n:].copy()


def vandermonde(rows: int, cols: int) -> np.ndarray:
    """V[r, c] = r^c with gf_pow's 0^0 == 1 convention (Backblaze)."""
    v = np.zeros((rows, cols), dtype=np.uint8)
    for r in range(rows):
        for c in range(cols):
            v[r, c] = gf256.gf_pow(r, c)
    return v


def build_encode_matrix(data: int, parity: int) -> np.ndarray:
    """The systematic (d+p) x d encode matrix; top d rows are the identity.

    Matches ``reed-solomon-erasure``'s ``ReedSolomon::new(data, parity)``
    internal matrix so shards interoperate with reference-written clusters.
    """
    if data < 1:
        raise ErasureError("data shard count must be >= 1")
    if parity < 0:
        raise ErasureError("parity shard count must be >= 0")
    if data + parity > 256:
        raise ErasureError("d + p must be <= 256 for GF(2^8) Vandermonde")
    v = vandermonde(data + parity, data)
    top_inv = gf_invert(v[:data])
    e = gf_matmul(v, top_inv)
    # Systematic property: the construction guarantees E[:d] == I.
    assert np.array_equal(e[:data], gf_identity(data))
    return e


def decode_matrix(
    encode: np.ndarray, present: list[int], wanted: list[int]
) -> np.ndarray:
    """Rows that rebuild ``wanted`` shards from the first-d ``present`` ones.

    ``present`` — indices (into the d+p shard list) of >= d intact shards;
    only the first d are used, mirroring the reference codec's reconstruction
    (it inverts the submatrix of d surviving rows).  ``wanted`` — indices of
    shards to reproduce.  Returns [len(wanted), d] over GF(2^8).
    """
    d = encode.shape[1]
    if len(present) < d:
        raise ErasureError(
            f"need at least {d} present shards, have {len(present)}"
        )
    sub = encode[np.array(present[:d], dtype=np.intp)]
    sub_inv = gf_invert(sub)  # maps surviving shard bytes -> data bytes
    rows = encode[np.array(wanted, dtype=np.intp)]
    return gf_matmul(rows, sub_inv)
