"""GF(2^8) matrix apply: the CUDA kernel's wrapper and its plain version.

``apply_matrix(table, shards)`` computes the ``ErasureBackend.apply_matrix``
contract, ``out[b, i, s] = XOR_k mat[i, k] (x) shards[b, k, s]``, on tensors:
``table`` is ``to_device_matrix(mat, device)``, ``shards`` is uint8
``[B, K, S]``, the result uint8 ``[B, R, S]``.

* For a CUDA tensor it launches ``csrc/gf_apply.cu`` (the port of
  ``chunky_bits_tpu/ops/pallas_kernels.py::_build_kernel``; its source
  note gives the bound on an H100 and the design: the 0/1 bit-matrix times
  the data's own bits on the binary tensor cores, ``mma.sync`` b1
  ``and.popc``) or raises.
* For a CPU tensor it runs ``apply_matrix_plain``, the port of
  ``chunky_bits_tpu/ops/bitplane.py``: unpack bytes to bits, 0/1 products
  summed in integers, mod 2, pack.  It computes the same bytes on any
  device and is what the kernel is held against.

``apply_matrix_packed(table, shards)`` computes the same bytes with the
field-multiplexed kernel, ``csrc/gf_apply_packed.cu`` (the port of
``pallas_kernels.py::_build_packed_kernel``), on the int8 tensor cores; its
plain version is ``apply_matrix_packed_plain``.  It takes only the
geometries of ``packed_geometry_ok`` and raises on any other.
``apply_selected`` is the one place that chooses between the two kernels,
as ``apply_m2_bitmajor`` does in the JAX package.

``accumulate(table, shards)`` stops before the mod 2: int16 ``[B, 8R, S]``
popcounts in the JAX package's bit-major row order (row ``bit*R + i`` is
bit ``bit`` of output byte-row i), through ``csrc/gf_acc.cu`` (the port of
``pallas_kernels.py::_build_kernel(pack=False)``, ``acc_m2_bitmajor``).
The kernel counts on the int8 tensor cores: the weight ``acc_weight``
(``[8R, 8K]`` of 0/1) in shared memory as ``mma.sync`` A fragments, the
data's bit-planes built in registers as B fragments, int32 sums stored as
int16 in 16-byte stores.  Its bound is the bytes, since it writes 16 bytes
per output byte-row and column: ~1.0 ms at a config-5 tp rank
``[8, 5, 4 MiB]`` at 3.35 TB/s.  Its plain version is
``accumulate_plain``.  Counts of column blocks of one matrix add,
so the ``tp`` layout of the mesh reduces its ranks' partials and packs
them once: ``reduce_pack(partials)``, one kernel (``csrc/gf_acc_pack.cu``,
the counterpart of ``psum`` + ``pack_acc_bitmajor``, which XLA fuses) that
reads each partial once and writes bytes.  Its plain version
``reduce_pack_plain`` sums in int16 and packs with ``pack_acc``.

``LAUNCHES``, ``PACKED_LAUNCHES``, ``ACC_LAUNCHES`` and
``REDUCE_PACK_LAUNCHES`` count the four kernels' launches, and nothing else.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import gf256

#: kernel launches made by ``apply_matrix`` in this process
LAUNCHES = 0
#: kernel launches made by ``apply_matrix_packed`` in this process
PACKED_LAUNCHES = 0
#: kernel launches made by ``accumulate`` in this process
ACC_LAUNCHES = 0
#: kernel launches made by ``reduce_pack`` in this process
REDUCE_PACK_LAUNCHES = 0
_COUNT_LOCK = threading.Lock()

#: device memory the plain version may use for one slab of parts
_PLAIN_SLAB_BYTES = 1 << 30


def expand_table(mat: np.ndarray) -> np.ndarray:
    """uint8 ``[R, K, 8]`` with ``T[i, k, j] = mat[i, k] (x) 2^j``: the
    columns of ``gf256.mul_bit_matrix(mat[i, k])`` as bytes.  ``T[..., 0]``
    is ``mat`` itself."""
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    if mat.ndim != 2:
        raise ErasureError(f"want a GF matrix [R, K], got {mat.shape}")
    powers = np.array([1 << j for j in range(8)], dtype=np.intp)
    return gf256.MUL_TABLE[mat[:, :, None], powers[None, None, :]]


def to_device_matrix(mat: np.ndarray, device) -> torch.Tensor:
    """The kernel's operand for a GF matrix ``[R, K]`` (the counterpart of
    ``bitmajor_device_matrix``): ``expand_table(mat)`` as a uint8 tensor
    on ``device``.  Takes the JAX package's matrices as they are."""
    return torch.from_numpy(expand_table(mat)).to(device)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """``[n, R, 8, S]`` of 0/1 (bit j at index j) -> uint8 ``[n, R, S]``."""
    shifts = torch.arange(8, device=bits.device, dtype=torch.int16)
    return (bits.to(torch.int16) << shifts[None, None, :, None]).sum(
        dim=2).to(torch.uint8)


def apply_matrix_plain(table: torch.Tensor,
                       shards: torch.Tensor) -> torch.Tensor:
    """The plain version of the kernel on any device: bit-matrix product
    over GF(2) in integer arithmetic.  ``M2[i*8+b, k*8+j]`` is bit ``b``
    of ``table[i, k, j]``; ``out_bits = (M2 @ bits(shards)) mod 2``, the
    sum taken in int16 (at most 8K <= 2048 ones), then packed."""
    r, k, _ = table.shape
    n_parts, k2, s = shards.shape
    if k2 != k:
        raise ErasureError(f"matrix has {k} columns, shards {k2} rows")
    out = torch.empty((n_parts, r, s), dtype=torch.uint8,
                      device=shards.device)
    if out.numel() == 0:
        return out.zero_()
    dev = shards.device
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    m2 = ((table.to(dev)[:, None, :, :] >> shifts[None, :, None, None]) & 1)
    m2 = m2.reshape(r * 8, k * 8).to(torch.int16)
    slab = max(1, _PLAIN_SLAB_BYTES // max(1, s * (k * 8 + r * 8 * 4)))
    for lo in range(0, n_parts, slab):
        part = shards[lo:lo + slab]
        bits = ((part[:, :, None, :] >> shifts[None, None, :, None]) & 1)
        bits = bits.reshape(part.shape[0], k * 8, s).to(torch.int16)
        acc = torch.zeros((part.shape[0], r * 8, s), dtype=torch.int16,
                          device=dev)
        for c in range(k * 8):
            acc += m2[None, :, c, None] * bits[:, None, c, :]
        out[lo:lo + slab] = _pack_bits(
            (acc & 1).reshape(part.shape[0], r, 8, s))
    return out


def _check(table: torch.Tensor, shards: torch.Tensor) -> None:
    if table.dtype != torch.uint8 or shards.dtype != torch.uint8:
        raise ErasureError("table and shards must be uint8")
    if table.ndim != 3 or table.shape[2] != 8:
        raise ErasureError(f"want a table [R, K, 8], got {tuple(table.shape)}")
    if shards.ndim != 3 or shards.shape[1] != table.shape[1]:
        raise ErasureError(f"want shards [B, {table.shape[1]}, S], got "
                           f"{tuple(shards.shape)}")


def _launch(name: str, table: torch.Tensor, shards: torch.Tensor,
            rows: Optional[int] = None,
            dtype: torch.dtype = torch.uint8) -> torch.Tensor:
    """Launch kernel ``name`` (a source of ``csrc/``) on CUDA tensors and
    return its output ``[B, rows, S]`` of ``dtype`` (``rows`` defaults to
    R); raises on a failed build or launch.  An empty output is returned
    without a launch."""
    if shards.device.type != "cuda" or table.device != shards.device:
        raise ErasureError(f"{name} takes CUDA tensors on one device, got "
                           f"{table.device} and {shards.device}")
    r, k, _ = table.shape
    b, _, s = shards.shape
    out = torch.empty((b, r if rows is None else rows, s), dtype=dtype,
                      device=shards.device)
    if out.numel() == 0:
        return out
    table = table.contiguous()
    shards = shards.contiguous()
    fn, error_string = _library(name)
    with torch.cuda.device(shards.device):
        stream = torch.cuda.current_stream(shards.device).cuda_stream
        err = fn(table.data_ptr(), shards.data_ptr(), out.data_ptr(), b, k,
                 r, s, stream)
    if err != 0:
        raise ErasureError(
            f"{name} launch failed: {error_string(err).decode()}")
    return out


#: largest K the kernel takes (the coder's stripes are at most 255 wide)
APPLY_MAX_K = 255


def apply_matrix(table: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """``out[b, i, s] = XOR_k mat[i, k] (x) shards[b, k, s]``: the kernel
    for a CUDA tensor (K <= 255, else ``ErasureError``), the plain version
    for a CPU tensor.  B, R or S of 0 return an empty result without a
    launch."""
    global LAUNCHES
    _check(table, shards)
    if shards.device.type == "cpu":
        return apply_matrix_plain(table, shards)
    if table.shape[1] > APPLY_MAX_K:
        raise ErasureError(f"apply_matrix takes K <= {APPLY_MAX_K}, got "
                           f"{table.shape[1]}")
    out = _launch("gf_apply", table, shards)
    if out.numel():
        with _COUNT_LOCK:
            LAUNCHES += 1
    return out


def packed_geometry_ok(r: int, k: int, s: int) -> bool:
    """The field-multiplexed kernel's gate, with the JAX package's exact
    semantics: doubled output rows within 128 (r <= 8), per-field
    popcounts within 6 bits (ceil(8k / 2) <= 63, k <= 15), and S a
    multiple of 256."""
    return 0 < r <= 8 and 0 < k <= 15 and s % 256 == 0


def _check_packed(table: torch.Tensor, shards: torch.Tensor) -> None:
    _check(table, shards)
    r, k, _ = table.shape
    s = shards.shape[2]
    if not packed_geometry_ok(r, k, s):
        raise ErasureError(
            f"geometry r={r} k={k} s={s} outside the packed kernel's gate")


def apply_matrix_packed_plain(table: torch.Tensor,
                              shards: torch.Tensor) -> torch.Tensor:
    """The plain version of the packed kernel on any device, in its
    arithmetic: bytes 2n and 2n+1 of a shard row share element n of a
    bit-plane (bit 0 and bit 6), the block-diagonal weight
    ``[2 * 8R, 8K]`` splits the contraction at ``kc = 4K``, the sums are
    int32, and the two halves' fields give the output bits
    (``lo = (a0 ^ a1) & 1``, ``hi = ((a0 ^ a1) >> 6) & 1``).  Sums of
    products, no matmul, so it runs on the card as well."""
    _check_packed(table, shards)
    r, k, _ = table.shape
    n_parts, _, s = shards.shape
    out = torch.empty((n_parts, r, s), dtype=torch.uint8,
                      device=shards.device)
    if out.numel() == 0:
        return out.zero_()
    dev = shards.device
    r8, k8, kc, half = 8 * r, 8 * k, 4 * k, s // 2
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    m2 = ((table.to(dev)[:, None, :, :] >> shifts[None, :, None, None]) & 1)
    m2 = m2.reshape(r8, k8).to(torch.int32)
    col = torch.arange(k8, device=dev)[None, :]
    weight = torch.cat([m2 * (col < kc), m2 * (col >= kc)])  # [2*R8, K8]
    slab = max(1, _PLAIN_SLAB_BYTES // max(1, half * 4 * (k8 + 4 * r8)))
    for lo in range(0, n_parts, slab):
        part = shards[lo:lo + slab]
        n = part.shape[0]
        pair = part.reshape(n, k, half, 2)
        bits = (pair[:, :, None] >> shifts[None, None, :, None, None]) & 1
        elems = bits[..., 0] | (bits[..., 1] << 6)  # [n, K, 8, S/2]
        elems = elems.reshape(n, k8, half).to(torch.int32)
        acc = torch.zeros((n, 2 * r8, half), dtype=torch.int32, device=dev)
        for c in range(k8):
            acc += weight[None, :, c, None] * elems[:, None, c, :]
        x = acc[:, :r8] ^ acc[:, r8:]
        both = torch.stack([x & 1, (x >> 6) & 1], dim=-1)  # [n, R8, S/2, 2]
        out[lo:lo + slab] = _pack_bits(both.reshape(n, r, 8, s))
    return out


def apply_matrix_packed(table: torch.Tensor,
                        shards: torch.Tensor) -> torch.Tensor:
    """The same bytes as ``apply_matrix`` through the packed kernel for a
    CUDA tensor (the plain version for a CPU tensor); a geometry outside
    ``packed_geometry_ok`` raises ``ErasureError``."""
    global PACKED_LAUNCHES
    _check_packed(table, shards)
    if shards.device.type == "cpu":
        return apply_matrix_packed_plain(table, shards)
    out = _launch("gf_apply_packed", table, shards)
    if out.numel():
        with _COUNT_LOCK:
            PACKED_LAUNCHES += 1
    return out


def apply_selected(table: torch.Tensor, shards: torch.Tensor,
                   packed: bool) -> torch.Tensor:
    """The kernel choice of ``apply_m2_bitmajor``: the packed kernel when
    ``packed`` is asked for and the geometry is inside its gate, else
    ``apply_matrix``."""
    r, k, _ = table.shape
    if packed and packed_geometry_ok(r, k, shards.shape[2]):
        return apply_matrix_packed(table, shards)
    return apply_matrix(table, shards)


#: largest K whose counts ``accumulate`` keeps exact in int16 lanes
ACC_MAX_K = 4095


def _check_acc(table: torch.Tensor, shards: torch.Tensor) -> None:
    _check(table, shards)
    if table.shape[1] > ACC_MAX_K:
        raise ErasureError(f"accumulate takes K <= {ACC_MAX_K}, got "
                           f"{table.shape[1]}")


def acc_weight(table: torch.Tensor) -> torch.Tensor:
    """The accumulator's 0/1 weight, uint8 ``[8R, 8K]`` on the table's
    device: ``M2[bit*R + i, k*8 + j]`` is bit ``bit`` of
    ``table[i, k, j]``.  Rows in the JAX package's bit-major order
    (``bit_matrix_bitmajor``), columns ``k*8 + j``: bit j of input byte-row
    k, the order of the kernel's A fragments."""
    r, k, _ = table.shape
    shifts = torch.arange(8, device=table.device, dtype=torch.uint8)
    m2 = (table[None] >> shifts[:, None, None, None]) & 1
    return m2.reshape(8 * r, k * 8)


def accumulate_plain(table: torch.Tensor,
                     shards: torch.Tensor) -> torch.Tensor:
    """The plain version of the accumulator kernel on any device: int16
    ``[B, 8R, S]`` with ``acc[b, bit*R + i, s] = sum over k, j of
    bit_bit(table[i, k, j]) * bit_j(shards[b, k, s])``, the sums of 0/1
    products taken in int16 (at most 8K ones).  The bit-major row order is
    the JAX package's, not the ``i*8 + b`` order of
    ``apply_matrix_plain``."""
    _check_acc(table, shards)
    r, k, _ = table.shape
    n_parts, _, s = shards.shape
    dev = shards.device
    out = torch.zeros((n_parts, 8 * r, s), dtype=torch.int16, device=dev)
    if out.numel() == 0:
        return out
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    m2 = acc_weight(table.to(dev)).to(torch.int16)
    slab = max(1, _PLAIN_SLAB_BYTES // max(1, s * (k * 8 + r * 8 * 4)))
    for lo in range(0, n_parts, slab):
        part = shards[lo:lo + slab]
        bits = ((part[:, :, None, :] >> shifts[None, None, :, None]) & 1)
        bits = bits.reshape(part.shape[0], k * 8, s).to(torch.int16)
        acc = out[lo:lo + slab]
        for c in range(k * 8):
            acc += m2[None, :, c, None] * bits[:, None, c, :]
    return out


def accumulate(table: torch.Tensor, shards: torch.Tensor) -> torch.Tensor:
    """int16 ``[B, 8R, S]`` bit-major popcounts before the mod 2: the
    kernel for a CUDA tensor, the plain version for a CPU tensor.  B, R
    or S of 0 return an empty result without a launch."""
    global ACC_LAUNCHES
    _check_acc(table, shards)
    if shards.device.type == "cpu":
        return accumulate_plain(table, shards)
    out = _launch("gf_acc", table, shards, rows=8 * table.shape[0],
                  dtype=torch.int16)
    if out.numel():
        with _COUNT_LOCK:
            ACC_LAUNCHES += 1
    return out


def pack_acc(acc: torch.Tensor) -> torch.Tensor:
    """Bit-major popcounts ``[B, 8R, S]`` (any integer dtype) -> uint8
    ``[B, R, S]``: bit ``bit`` of byte-row i is the parity of row
    ``bit*R + i`` (the counterpart of ``pack_acc_bitmajor``).  Plain torch
    ops on the tensor's device; one uint8 plane at a time."""
    b, r8, s = acc.shape
    if r8 % 8:
        raise ErasureError(f"want [B, 8R, S] popcounts, got {tuple(acc.shape)}")
    planes = acc.reshape(b, 8, r8 // 8, s)
    out = (planes[:, 0] & 1).to(torch.uint8)
    for bit in range(1, 8):
        out |= ((planes[:, bit] & 1).to(torch.uint8) << bit)
    return out


#: most partials ``reduce_pack`` takes in one launch (a tp extent)
PACK_MAX_PARTS = 8


def _check_pack(partials) -> tuple[int, int, int]:
    if not 1 <= len(partials) <= PACK_MAX_PARTS:
        raise ErasureError(f"reduce_pack takes 1 to {PACK_MAX_PARTS} "
                           f"partials, got {len(partials)}")
    first = partials[0]
    for p in partials:
        if p.dtype != torch.int16 or p.ndim != 3 or p.shape[1] % 8:
            raise ErasureError(f"want int16 [B, 8R, S] partials, got "
                               f"{p.dtype} {tuple(p.shape)}")
        if p.shape != first.shape or p.device != first.device:
            raise ErasureError(
                f"partials differ: {tuple(p.shape)} on {p.device}, "
                f"{tuple(first.shape)} on {first.device}")
    b, r8, s = first.shape
    return b, r8 // 8, s


def reduce_pack_plain(partials) -> torch.Tensor:
    """The plain version of the reduce-and-pack kernel on any device: the
    partials summed in int16 (into a copy of the first, so no input is
    written), then ``pack_acc``."""
    _check_pack(partials)
    total = partials[0].clone()
    for p in partials[1:]:
        total.add_(p)  # int16 in place: no promotion
    return pack_acc(total)


def reduce_pack(partials) -> torch.Tensor:
    """tp int16 bit-major partials ``[B, 8R, S]`` on one device -> uint8
    ``[B, R, S]``: bit ``bit`` of byte-row i is the parity of the sum of
    row ``bit*R + i`` over the partials.  The kernel for CUDA tensors
    (each partial read once, each byte written once), the plain version
    for CPU tensors.  B, R or S of 0 return an empty result without a
    launch."""
    global REDUCE_PACK_LAUNCHES
    b, r, s = _check_pack(partials)
    dev = partials[0].device
    if dev.type == "cpu":
        return reduce_pack_plain(partials)
    if dev.type != "cuda":
        raise ErasureError(f"reduce_pack takes CUDA or CPU tensors, got {dev}")
    out = torch.empty((b, r, s), dtype=torch.uint8, device=dev)
    if out.numel() == 0:
        return out
    parts = [p.contiguous() for p in partials]
    fn, error_string = _library("gf_acc_pack")
    ptrs = (ctypes.c_void_p * len(parts))(*[p.data_ptr() for p in parts])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ptrs, len(parts), out.data_ptr(), b, r, s, stream)
    if err != 0:
        raise ErasureError(
            f"gf_acc_pack launch failed: {error_string(err).decode()}")
    with _COUNT_LOCK:
        REDUCE_PACK_LAUNCHES += 1
    return out


#: the C signature of each kernel's launch, ``cb_<name>``: (table, in,
#: out, B, K, R, S, stream), or for the reduce-and-pack (partials, tp, out,
#: B, R, S, stream)
_ARGTYPES = {
    "gf_acc_pack": [ctypes.POINTER(ctypes.c_void_p), ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_longlong, ctypes.c_void_p],
}
_TABLE_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p]


def _library(name: str):
    """``(launch, error_string)`` of kernel ``name``'s shared library."""
    from chunky_bits_tpu_torch.ops import _build

    lib = _build.load(name)
    fn = getattr(lib, f"cb_{name}")
    err = lib.cb_gf_error_string
    if fn.argtypes is None:
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES.get(name, _TABLE_ARGTYPES)
    return fn, err
