"""The native host codec: the port's own ``csrc/gf256.cpp`` through ctypes.

The port of ``chunky_bits_tpu/ops/cpu_backend.py``.  The C++ source is host
code, not a CUDA kernel: ``ops/_build.py::host_library`` compiles it with
g++ at first use (``-march=native`` first, then without) into
``chunky_bits_tpu_torch/_build/``, and every call releases the GIL for its
whole length.  It gives the port:

* ``NativeBackend`` (``native``, ``native:N``): GF(2^8) matrix applies
  through the byte-table kernels (GFNI, AVX2 pshufb or scalar, picked at
  run time) or, with ``xor_schedule``, the scheduled-XOR engine
  (ops/xor_schedule.py + ``cb_xor_exec``), and the fused host
  encode+hash (``encode_and_hash``/``encode_and_hash_into``);
* the SHA-256 engine (SHA-NI when the CPU has it): ``sha256_buf``,
  ``sha256_rows`` (the row hasher of ``ops.backend.row_hasher``) and
  ``sha256_file``, the one-pass read+hash of a local file range.

The plain versions it is held against are numpy (``NumpyBackend``),
hashlib and ``xor_schedule.apply_numpy``.  A build that fails raises
``ErasureError``; nothing here stands in for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import threading
from typing import Optional

import numpy as np

from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import gf256
from chunky_bits_tpu_torch.ops.backend import ErasureBackend

_LOAD_LOCK = threading.Lock()
_LIB = None

_SIZE = ctypes.c_size_t
_PTR = ctypes.c_void_p
_CHARS = ctypes.c_char_p
#: C prototypes of the library: name -> (argtypes, restype)
_PROTOTYPES = {
    "cb_apply_matrix": ([_CHARS, _SIZE, _SIZE, _CHARS, _SIZE, _SIZE, _PTR,
                         ctypes.c_int], None),
    "cb_gf_mul": ([ctypes.c_uint8, ctypes.c_uint8], ctypes.c_uint8),
    "cb_sha256": ([_CHARS, _SIZE, _PTR], None),
    "cb_sha256_is_accelerated": ([], ctypes.c_int),
    "cb_sha256_file": ([_CHARS, ctypes.c_uint64, ctypes.c_uint64, _PTR],
                       ctypes.c_int),
    "cb_sha256_rows": ([_CHARS, _SIZE, _SIZE, _PTR, ctypes.c_int], None),
    "cb_encode_hash": ([_CHARS, _SIZE, _SIZE, _CHARS, _SIZE, _SIZE, _PTR,
                        _PTR, ctypes.c_int], None),
    "cb_xor_exec": ([_PTR, _SIZE, _SIZE, _SIZE, _SIZE, _CHARS, _SIZE, _SIZE,
                     _PTR, ctypes.c_int], None),
    "cb_xor_set_impl": ([ctypes.c_int], ctypes.c_int),
    "cb_xor_get_impl": ([], ctypes.c_int),
    "cb_gf_set_level": ([ctypes.c_int], ctypes.c_int),
    "cb_gf_get_level": ([], ctypes.c_int),
}


def _load() -> ctypes.CDLL:
    """The loaded codec, built at first use and checked against the
    Python field tables and hashlib before anything uses it."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOAD_LOCK:
        if _LIB is not None:
            return _LIB
        from chunky_bits_tpu_torch.ops import _build

        try:  # an unwritable build directory or a bad library
            lib = ctypes.CDLL(_build.host_library())
        except OSError as err:
            raise ErasureError(f"cannot build or load the native gf256 "
                               f"codec: {err}") from err
        for name, (args, res) in _PROTOTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        for a, b in ((2, 0x80), (3, 7), (255, 255), (29, 1)):
            if lib.cb_gf_mul(a, b) != gf256.gf_mul(a, b):
                raise ErasureError("native GF tables disagree with python")
        probe = b"chunky-bits-tpu sha self-check"
        out = ctypes.create_string_buffer(32)
        lib.cb_sha256(probe, len(probe), out)
        if out.raw != hashlib.sha256(probe).digest():
            raise ErasureError("native sha256 disagrees with hashlib")
        _LIB = lib
    return _LIB


def sha256_buf(data) -> bytes:
    """Native one-shot SHA-256 (SHA-NI when the CPU has it)."""
    lib = _load()
    out = ctypes.create_string_buffer(32)
    data = bytes(data)
    lib.cb_sha256(data, len(data), out)
    return out.raw


def sha256_is_accelerated() -> bool:
    """True when the SHA-NI path is the one in use."""
    return bool(_load().cb_sha256_is_accelerated())


def xor_force_impl(level: int) -> int:
    """Force the scheduled-XOR engine's kernel tier (0 scalar, 1 SSE2, 2
    AVX2), clamped to what this CPU has; returns the tier in effect.
    Process-wide."""
    return int(_load().cb_xor_set_impl(int(level)))


def gf_force_level(level: int) -> int:
    """Force the byte-table kernel tier (0 scalar table, 1 AVX2 pshufb, 2
    GFNI), clamped to what this build and CPU have; returns the tier in
    effect.  Every tier gives the same bytes.  Process-wide."""
    return int(_load().cb_gf_set_level(int(level)))


def native_tiers() -> dict:
    """The kernel tiers in effect: ``{"gf": 0-2, "xor": 0-2, "sha_ni":
    bool}``."""
    lib = _load()
    return {"gf": int(lib.cb_gf_get_level()),
            "xor": int(lib.cb_xor_get_impl()),
            "sha_ni": bool(lib.cb_sha256_is_accelerated())}


#: ``length`` of ``cb_sha256_file`` meaning "to the end of the file"
_ALL = 0xFFFFFFFFFFFFFFFF


def sha256_file(path: str, start: int = 0,
                length: Optional[int] = None) -> bytes:
    """SHA-256 of a file's byte range in one native streaming pass, the
    bytes never reaching Python: the read+hash of local chunk
    verification.  ``length=None`` hashes from ``start`` to the end.
    Raises OSError on an I/O error or a file shorter than the range."""
    lib = _load()
    out = ctypes.create_string_buffer(32)
    want = _ALL if length is None else int(length)
    rc = lib.cb_sha256_file(os.fsencode(path), int(start), want, out)
    if rc == -2:
        raise OSError(f"short file: {path!r} has fewer than "
                      f"{start + (length or 0)} bytes")
    if rc != 0:
        raise OSError(f"cannot hash {path!r}")
    return out.raw


def sha256_rows(rows: np.ndarray, out: np.ndarray,
                nthreads: int = 0) -> None:
    """``out[..., 32]`` = SHA-256 of each row of uint8 ``rows[..., S]``, in
    one threaded call without the GIL.  ``nthreads`` bounds the call's
    own threads (0 = one per core); the host pipeline passes 1 per slice.
    ``out`` must be C-contiguous."""
    lib = _load()
    n = int(np.prod(rows.shape[:-1]))
    if n == 0 or rows.shape[-1] == 0:
        out[...] = np.frombuffer(hashlib.sha256(b"").digest(),
                                 dtype=np.uint8)
        return
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    if not out.flags.c_contiguous:
        raise ErasureError("sha256_rows needs a contiguous output")
    if out.dtype != np.uint8 or out.size != 32 * n:
        raise ErasureError(f"sha256_rows: {n} rows need a uint8 output of "
                           f"{32 * n} bytes, got {out.dtype} {out.shape}")
    lib.cb_sha256_rows(rows.ctypes.data_as(_CHARS), n, rows.shape[-1],
                       out.ctypes.data_as(_PTR), int(nthreads))


def _check_geometry(mat: np.ndarray, shards: np.ndarray) -> None:
    """The C entry points trust their sizes: refuse a matrix whose columns
    are not the shards' rows before any pointer is passed."""
    if mat.ndim != 2 or shards.ndim != 3 or mat.shape[1] != shards.shape[1]:
        raise ErasureError(f"matrix {mat.shape} does not apply to shards "
                           f"{shards.shape}")


class NativeBackend(ErasureBackend):
    """The C++ codec through ctypes, threaded across the batch.

    ``nthreads`` bounds each call's threads (0 = one per core; ``native:N``
    sets N).  ``xor_schedule`` selects the scheduled-XOR engine for
    matrix applies: None reads ``tunables.xor_schedule_enabled`` at the
    first dispatch, a bool pins it for this instance.  The bytes are the
    same either way; shards whose length is not a multiple of 8 take the
    table kernels, call by call.
    """

    name = "native"

    def __init__(self, nthreads: int = 0,
                 xor_schedule: Optional[bool] = None) -> None:
        self.nthreads = nthreads
        self._lib = _load()
        self._xor = xor_schedule

    def _xor_enabled(self) -> bool:
        if self._xor is None:
            from chunky_bits_tpu_torch.cluster.tunables import (
                xor_schedule_enabled)

            self._xor = xor_schedule_enabled()
        return self._xor

    def _xor_apply(self, mat: np.ndarray, shards: np.ndarray,
                   out: np.ndarray, nthreads: int) -> None:
        """One batched apply through the scheduled-XOR engine (the caller
        ensures s % 8 == 0, r >= 1 and contiguous arrays)."""
        from chunky_bits_tpu_torch.ops import xor_schedule

        sched = xor_schedule.get_schedule(mat)
        b, _k, s = shards.shape
        self._lib.cb_xor_exec(
            sched.ops.ctypes.data_as(_PTR), sched.ops.shape[0],
            sched.n_planes, sched.k, sched.r,
            shards.ctypes.data_as(_CHARS), b, s,
            out.ctypes.data_as(_PTR), nthreads)

    def apply_matrix(self, mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
        _check_geometry(mat, shards)
        b, k, s = shards.shape
        r = mat.shape[0]
        out = np.zeros((b, r, s), dtype=np.uint8)
        if r == 0 or b == 0 or s == 0:
            return out
        mat = np.ascontiguousarray(mat, dtype=np.uint8)
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        if s % 8 == 0 and self._xor_enabled():
            self._xor_apply(mat, shards, out, self.nthreads)
            return out
        self._lib.cb_apply_matrix(
            mat.ctypes.data_as(_CHARS), r, k, shards.ctypes.data_as(_CHARS),
            b, s, out.ctypes.data_as(_PTR), self.nthreads)
        return out

    def encode_and_hash(
        self, mat: np.ndarray, shards: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """The fused ingest step: ``parity[b, r, s]`` and the SHA-256 of
        every data then parity shard, ``[b, k + r, 32]``, in one native
        pass per batch item while its shards are cache-hot."""
        b, k, s = shards.shape
        r = mat.shape[0]
        parity = np.zeros((b, r, s), dtype=np.uint8)
        hashes = np.zeros((b, k + r, 32), dtype=np.uint8)
        return self.encode_and_hash_into(mat, shards, parity, hashes,
                                         self.nthreads)

    def encode_and_hash_into(
        self, mat: np.ndarray, shards: np.ndarray,
        out_parity: np.ndarray, out_hashes: np.ndarray,
        nthreads: Optional[int] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """``encode_and_hash`` into the caller's contiguous
        ``out_parity[b, r, s]`` and ``out_hashes[b, k + r, 32]``: the host
        pipeline gives each worker a range of stripes with ``nthreads=1``,
        writing straight into its rows of the shared outputs."""
        _check_geometry(mat, shards)
        b, k, s = shards.shape
        r = mat.shape[0]
        if (out_parity.shape != (b, r, s) or out_hashes.shape != (b, k + r, 32)
                or out_parity.dtype != np.uint8
                or out_hashes.dtype != np.uint8):
            raise ErasureError(
                f"encode_and_hash_into: outputs {out_parity.shape} and "
                f"{out_hashes.shape} do not fit shards {shards.shape} and "
                f"{r} parity rows")
        if b == 0 or s == 0:
            # empty shards still hash: sha256(b"") as the generic path
            if b and s == 0:
                out_hashes[:, :] = np.frombuffer(
                    hashlib.sha256(b"").digest(), dtype=np.uint8)
            return out_parity, out_hashes
        if not (out_parity.flags.c_contiguous
                and out_hashes.flags.c_contiguous):
            raise ErasureError("encode_and_hash_into needs contiguous "
                               "outputs")
        mat = np.ascontiguousarray(mat, dtype=np.uint8)
        shards = np.ascontiguousarray(shards, dtype=np.uint8)
        nt = self.nthreads if nthreads is None else int(nthreads)
        if r > 0 and s % 8 == 0 and self._xor_enabled():
            # parity through the scheduled program, then the row hasher
            # over the data and the parity rows, one call per family
            self._xor_apply(mat, shards, out_parity, nt)
            ddig = np.empty((b * k, 32), dtype=np.uint8)
            self._lib.cb_sha256_rows(shards.ctypes.data_as(_CHARS), b * k,
                                     s, ddig.ctypes.data_as(_PTR), nt)
            out_hashes[:, :k] = ddig.reshape(b, k, 32)
            pdig = np.empty((b * r, 32), dtype=np.uint8)
            self._lib.cb_sha256_rows(out_parity.ctypes.data_as(_CHARS),
                                     b * r, s, pdig.ctypes.data_as(_PTR), nt)
            out_hashes[:, k:] = pdig.reshape(b, r, 32)
            return out_parity, out_hashes
        self._lib.cb_encode_hash(
            mat.ctypes.data_as(_CHARS), r, k, shards.ctypes.data_as(_CHARS),
            b, s, out_parity.ctypes.data_as(_PTR),
            out_hashes.ctypes.data_as(_PTR), nt)
        return out_parity, out_hashes
