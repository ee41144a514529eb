"""Per-row SHA-256: the CUDA kernel's wrapper and its plain version.

``sha256_rows(rows)`` hashes each row of uint8 ``[N, S]`` into uint8
``[N, 32]``, byte-identical to hashlib (FIPS 180-4 padding included).
``sha256_parts(a, b)`` hashes the rows of ``a[P, ga, S]`` and
``b[P, gb, S]`` into ``[P, ga + gb, 32]`` in one launch: the fused ingest
hashes data and parity shards without concatenating them.

* For a CUDA tensor these launch ``csrc/sha256_rows.cu`` (the port of the
  device SHA in ``chunky_bits_tpu/ops/sha256_jax.py``) or raise.  A row
  is a lane; a block of two warps serves 32 rows, the producer warp
  loading the message blocks and expanding the schedule into shared
  memory, the consumer warp running only the 64 rounds.  Each row's
  compressions are one dependent chain, so a launch of few rows (the
  fused ingest's 1,792 fill 56 warps) is bound by the cycles one
  compression's rounds take on one warp, not by the card's lanes or
  bytes; the source note gives both bounds.
* For a CPU tensor they run ``sha256_rows_plain``: the same rounds in
  torch, vectorised over rows.  It computes in int64 lanes masked to 32
  bits, since torch's CPU build has no ``>>``, ``<<``, ``+`` or ``~`` for
  ``torch.uint32``.  On the card, where it serves as the kernel's
  reference, it replays one compression as a CUDA graph per block.

``LAUNCHES`` counts kernel launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from chunky_bits_tpu_torch.errors import ErasureError

#: kernel launches made by ``sha256_parts``/``sha256_rows`` in this process
LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

# FIPS 180-4 round constants and initial hash value
_K = (
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
)
_H0 = (0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
       0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19)
_M = 0xFFFFFFFF

#: instructions one compression needs on sm_90 (producer and consumer
#: together), the count behind the kernel's operation bound.  A 3-input LOP3 or IADD3 and a funnel shift
#: (SHF) are one instruction each.  A round is 14: Σ0 and Σ1 are 3 SHF and
#: a 3-way XOR (LOP3) each, Ch and Maj one LOP3 each, T1's five terms two
#: IADD3 (K is an immediate), e and a one IADD3 each.  A schedule step is
#: 10: σ0 and σ1 are 2 rotates, a shift and a LOP3 each, W's four terms
#: two IADD3.  Then 8 final adds and 16 byte swaps (PRMT) to load the
#: block's words big-endian.
OPS_PER_BLOCK = 64 * 14 + 48 * 10 + 8 + 16


def pad_tail(row_bytes: int) -> np.ndarray:
    """The FIPS 180-4 suffix of a ``row_bytes`` message: 0x80, zeros to
    56 mod 64, then the bit length as a big-endian u64."""
    zeros = (64 - (row_bytes + 9) % 64) % 64
    tail = b"\x80" + b"\x00" * zeros + (row_bytes * 8).to_bytes(8, "big")
    return np.frombuffer(tail, dtype=np.uint8)


def blocks_per_row(row_bytes: int) -> int:
    """64-byte compressions one padded row takes."""
    return (row_bytes + pad_tail(row_bytes).size) // 64


def _twice(x: torch.Tensor) -> torch.Tensor:
    """``x`` (below 2^32) with its low 25 bits copied above bit 31: bits
    n..n+31 of the result are ``rotr(x, n)`` for every n <= 25, and it
    stays below 2^57, so sums of a few such words cannot overflow int64."""
    return x | ((x & 0x1FFFFFF) << 32)


def _compress(h: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    """One compression of every row: state int64 ``[N, 8]`` and a 64-byte
    block uint8 ``[N, 64]`` give the next state.

    Words live in int64 lanes and are clean (below 2^32) where they are
    shifted right or doubled.  Rotates and sums leave bits above 31; the
    masks on e, a, W and the state drop them, since the low 32 bits of a
    sum depend on the low 32 bits of its terms alone."""
    b = block.to(torch.int64).reshape(-1, 16, 4)
    w = list(((b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8)
              | b[..., 3]).unbind(1))
    for t in range(16, 64):
        w15, w2 = w[t - 15], w[t - 2]
        x15, x2 = _twice(w15), _twice(w2)
        s0 = (x15 >> 7) ^ (x15 >> 18) ^ (w15 >> 3)
        s1 = (x2 >> 17) ^ (x2 >> 19) ^ (w2 >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & _M)
    a, b, c, d, e, f, g, hh = h.unbind(1)
    for t in range(64):
        xe, xa = _twice(e), _twice(a)
        t1 = (hh + ((xe >> 6) ^ (xe >> 11) ^ (xe >> 25))
              + (g ^ (e & (f ^ g))) + _K[t] + w[t])
        t2 = ((xa >> 2) ^ (xa >> 13) ^ (xa >> 22)) + ((a & b) | (c & (a | b)))
        hh, g, f, e = g, f, e, (d + t1) & _M
        d, c, b, a = c, b, a, (t1 + t2) & _M
    return (h + torch.stack((a, b, c, d, e, f, g, hh), dim=1)) & _M


def _compress_on_graph(h: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    """``_compress`` over every block of ``msg`` on the card, one CUDA
    graph replay a block: the same ops, issued without thousands of Python
    calls a block."""
    block = msg[:, :64].clone()
    side = torch.cuda.Stream(msg.device)
    side.wait_stream(torch.cuda.current_stream(msg.device))
    with torch.cuda.stream(side):  # load every op's kernel before capture
        _compress(h, block)
    torch.cuda.current_stream(msg.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        h.copy_(_compress(h, block))
    for blk in range(msg.shape[1] // 64):
        block.copy_(msg[:, 64 * blk:64 * blk + 64])
        graph.replay()
    return h


def sha256_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each row of uint8 ``[N, S]`` on any device, as uint8
    ``[N, 32]``: one vector op per step of the standard, over all rows."""
    if rows.dtype != torch.uint8 or rows.ndim != 2:
        raise ErasureError(f"want uint8 rows [N, S], got {rows.dtype} "
                           f"{tuple(rows.shape)}")
    n, s = rows.shape
    dev = rows.device
    if n == 0:
        return torch.empty((0, 32), dtype=torch.uint8, device=dev)
    tail = torch.from_numpy(pad_tail(s).copy()).to(dev)
    msg = torch.cat([rows, tail.expand(n, -1)], dim=1)
    h = torch.tensor(_H0, dtype=torch.int64, device=dev).repeat(n, 1)
    if dev.type == "cuda":
        h = _compress_on_graph(h, msg)
    else:
        for blk in range(msg.shape[1] // 64):
            h = _compress(h, msg[:, 64 * blk:64 * blk + 64])
    out = torch.stack([(h >> sh) & 0xFF for sh in (24, 16, 8, 0)], dim=2)
    return out.reshape(n, 32).to(torch.uint8)


def sha256_parts(a: torch.Tensor,
                 b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Digests of the rows of ``a[P, ga, S]`` and ``b[P, gb, S]`` as
    uint8 ``[P, ga + gb, 32]`` (``a``'s rows first in each part): the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    global LAUNCHES
    if a.dtype != torch.uint8 or a.ndim != 3:
        raise ErasureError(f"want uint8 [P, g, S], got {a.dtype} "
                           f"{tuple(a.shape)}")
    p, ga, s = a.shape
    if b is not None and (b.dtype != torch.uint8 or b.ndim != 3
                          or b.shape[0] != p or b.shape[2] != s
                          or b.device != a.device):
        raise ErasureError(f"second source {b.dtype} {tuple(b.shape)} on "
                           f"{b.device} does not match [{p}, g, {s}] on "
                           f"{a.device}")
    gb = 0 if b is None else b.shape[1]
    if a.device.type == "cpu":
        rows = a if b is None else torch.cat([a, b], dim=1)
        return sha256_rows_plain(rows.reshape(p * (ga + gb), s)).reshape(
            p, ga + gb, 32)
    if a.device.type != "cuda":
        raise ErasureError(f"sha256_rows takes CUDA or CPU tensors, got "
                           f"{a.device}")
    out = torch.empty((p, ga + gb, 32), dtype=torch.uint8, device=a.device)
    if out.numel() == 0:
        return out
    a = a.contiguous()
    b = None if b is None else b.contiguous()
    lib = _library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.cb_sha256_rows(a.data_ptr(), ga,
                                 None if b is None else b.data_ptr(), gb,
                                 p, s, out.data_ptr(), stream)
    if err != 0:
        raise ErasureError(f"sha256_rows launch failed: "
                           f"{lib.cb_sha256_error_string(err).decode()}")
    with _COUNT_LOCK:
        LAUNCHES += 1
    return out


def sha256_rows(rows: torch.Tensor) -> torch.Tensor:
    """SHA-256 of each row of uint8 ``[N, S]`` as uint8 ``[N, 32]``."""
    if rows.ndim != 2:
        raise ErasureError(f"want rows [N, S], got {tuple(rows.shape)}")
    return sha256_parts(rows[:, None, :])[:, 0]


def _library() -> ctypes.CDLL:
    from chunky_bits_tpu_torch.ops import _build

    lib = _build.load("sha256_rows")
    if lib.cb_sha256_rows.argtypes is None:
        lib.cb_sha256_error_string.argtypes = [ctypes.c_int]
        lib.cb_sha256_error_string.restype = ctypes.c_char_p
        lib.cb_sha256_rows.restype = ctypes.c_int
        lib.cb_sha256_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
            ctypes.c_void_p]
    return lib
