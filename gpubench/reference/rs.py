"""Reed-Solomon over GF(2^8), plain NumPy: a frozen copy of the published
construction, sharing no code with the program.

Field: x^8 + x^4 + x^3 + x^2 + 1 (0x11d), generator 2.  The encode matrix
is the systematic Backblaze one, ``E = V @ inv(V[:d])`` with the
Vandermonde ``V[r, c] = r^c`` (``0^0 = 1``) of d + p rows; parity rows
are ``E[d:]``.  A lost row is rebuilt from the first d surviving rows by
``E[wanted] @ inv(E[present[:d]])``.
"""

from __future__ import annotations

import hashlib

import numpy as np

POLY = 0x11D


def _tables() -> tuple[np.ndarray, np.ndarray]:
    exp = np.zeros(510, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:] = exp[:255]
    return exp, log


EXP, LOG = _tables()


def mul(a: int, b: int) -> int:
    if a == 0 or b == 0:
        return 0
    return int(EXP[LOG[a] + LOG[b]])


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP[255 - LOG[a]])


def power(a: int, n: int) -> int:
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(EXP[(LOG[a] * n) % 255])


#: MUL[a] is the 256-entry row "a times every byte"
MUL = np.array([[mul(a, b) for b in range(256)] for a in range(256)],
               dtype=np.uint8)


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = 0
            for t in range(a.shape[1]):
                acc ^= mul(int(a[i, t]), int(b[t, j]))
            out[i, j] = acc
    return out


def invert(m: np.ndarray) -> np.ndarray:
    """Gauss-Jordan over GF(2^8); raises ValueError on a singular matrix."""
    n = m.shape[0]
    work = [[int(v) for v in row] + [int(i == r) for i in range(n)]
            for r, row in enumerate(m)]
    for col in range(n):
        pivot = next((r for r in range(col, n) if work[r][col]), None)
        if pivot is None:
            raise ValueError("singular matrix over GF(2^8)")
        work[col], work[pivot] = work[pivot], work[col]
        scale = inv(work[col][col])
        work[col] = [mul(scale, v) for v in work[col]]
        for r in range(n):
            f = work[r][col]
            if r != col and f:
                work[r] = [v ^ mul(f, w) for v, w in zip(work[r], work[col])]
    return np.array([row[n:] for row in work], dtype=np.uint8)


def encode_matrix(d: int, p: int) -> np.ndarray:
    """The systematic (d + p) x d matrix; its top d rows are the identity."""
    v = np.array([[power(r, c) for c in range(d)] for r in range(d + p)],
                 dtype=np.uint8)
    return matmul(v, invert(v[:d]))


def apply(mat: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``mat[r, k]`` applied to ``rows[k, S]``: ``out[r, S]``."""
    out = np.zeros((mat.shape[0], rows.shape[1]), dtype=np.uint8)
    for i in range(mat.shape[0]):
        for t in range(mat.shape[1]):
            c = int(mat[i, t])
            if c == 1:
                out[i] ^= rows[t]
            elif c:
                out[i] ^= np.take(MUL[c], rows[t])
    return out


def decode_matrix(d: int, p: int, present: list[int],
                  wanted: list[int]) -> np.ndarray:
    e = encode_matrix(d, p)
    return matmul(e[wanted], invert(e[sorted(present)[:d]]))


def split(part: bytes, d: int) -> np.ndarray:
    """One part's bytes as d rows of ``ceil(len / d)``, zero padded."""
    shard = -(-len(part) // d)
    rows = np.zeros(d * shard, dtype=np.uint8)
    rows[:len(part)] = np.frombuffer(part, dtype=np.uint8)
    return rows.reshape(d, shard)


def encode_part(part: bytes, d: int, p: int,
                mat: np.ndarray | None = None) -> tuple[int, list[bytes]]:
    """(shard length, SHA-256 of the d data rows then the p parity rows)
    of one part."""
    rows = split(part, d)
    mat = encode_matrix(d, p) if mat is None else mat
    parity = apply(mat[d:], rows)
    digests = [hashlib.sha256(r).digest() for r in rows]
    digests += [hashlib.sha256(r).digest() for r in parity]
    return rows.shape[1], digests
