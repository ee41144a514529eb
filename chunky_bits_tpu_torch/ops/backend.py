"""The ``ErasureBackend`` boundary and the per-geometry ``ErasureCoder``.

The port of ``chunky_bits_tpu/ops/backend.py``, at the same boundary the
reference has between its part codec and the ``reed-solomon-erasure``
crate (reference: src/file/file_part.rs:77,128,161-165,302-305).

A backend implements one primitive, applying a GF(2^8) matrix to a batch
of stacked shards; the coder builds the encode/decode matrices on the host
(they are tiny) and dispatches batches to it.  Data crosses as numpy uint8
arrays at the JAX package's layouts (matrix ``[R, K]``, shards
``[B, K, S]``, digests ``[B, d+p, 32]``).  Backends:

* ``numpy`` - pure-numpy table codec on the host.
* ``native`` - the C++ host codec (ops/cpu_backend.py, csrc/gf256.cpp
  built by g++); ``native:N`` caps its host threads at N.
* ``torch`` - the kernels' plain PyTorch versions on the CPU.
* ``cuda``  - the hand-written kernels on the card (ops/cuda_backend.py);
  the default.  It raises ``ErasureError`` when there is no card or a
  kernel fails; it never hands back a CPU backend in its place.
* ``mesh``  - every logical device, a layout per dispatch
  (ops/mesh_backend.py); ``cuda:<spec>`` (e.g. ``cuda:dp2,tp4``) - one
  explicit mesh (parallel/backend.py).  Both raise without a card.

A cluster YAML written for the JAX package names that package's backends.
``get_backend`` resolves them in one place (``canonical_backend_name``):
``jax`` is ``cuda``, ``jax:<spec>`` is ``cuda:<spec>``, and ``auto`` is
the default (the card, where the JAX package's ``auto`` means its native
codec).  ``native`` and ``native:N`` are the same codec in both packages.

All of them produce byte-identical shards and digests; tests assert it.
"""

from __future__ import annotations

import hashlib
import threading
import warnings
from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Callable, Optional, Sequence

import numpy as np

from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops import gf256, matrix

if TYPE_CHECKING:
    import torch

# torch and the kernels load where a ``torch``, ``cuda`` or mesh backend
# first runs (``as_tensor``, ``TorchBackend._apply``, ``get_backend``), so
# host-only commands never pay their import, as the JAX package's host
# paths never load jax.


def as_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``arr``'s memory, made contiguous first.  It
    aliases the caller's array, so nothing in the port writes into it;
    torch's warning for read-only arrays is silenced for that reason."""
    import torch

    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


class ErasureBackend(ABC):
    """Applies GF(2^8) matrices to batches of shards."""

    name: str = "abstract"

    @abstractmethod
    def apply_matrix(self, mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
        """out[b, i, s] = XOR_k mat[i, k] ⊗ shards[b, k, s].

        ``mat`` is uint8 [r, k]; ``shards`` is uint8 [B, k, S]; returns
        uint8 [B, r, S].
        """


class NumpyBackend(ErasureBackend):
    """Vectorized table-lookup codec on the host: the oracle."""

    name = "numpy"

    def apply_matrix(self, mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
        b, k, s = shards.shape
        r = mat.shape[0]
        out = np.zeros((b, r, s), dtype=np.uint8)
        for i in range(r):
            acc = out[:, i, :]
            for j in range(k):
                c = int(mat[i, j])
                if c == 0:
                    continue
                if c == 1:
                    acc ^= shards[:, j, :]
                else:
                    acc ^= gf256.gf_mul_bytes(c, shards[:, j, :])
        return out


def packed_enabled(packed: Optional[bool]) -> bool:
    """The ``packed`` knob of the torch and cuda backends: ``packed`` as
    set, or, when it is None, ``$CHUNKY_BITS_TORCH_PACKED_KERNEL`` read at
    each dispatch (off when unset, as in the JAX package).  Where it is
    on, the geometries inside ``gf_kernel.packed_geometry_ok`` take the
    packed kernel (``gf_kernel.apply_selected``)."""
    if packed is not None:
        return bool(packed)
    from chunky_bits_tpu_torch.cluster.tunables import (PACKED_KERNEL_ENV,
                                                        env_flag)

    return env_flag(PACKED_KERNEL_ENV)


class TorchBackend(ErasureBackend):
    """The kernels' plain PyTorch versions on the CPU, on the ``cuda``
    backend's default ingest route: parity from the plain version of the
    GF kernel that ``packed`` selects, and the digests of all d+p rows
    from hashlib on the host."""

    name = "torch"

    #: batchers merge concurrent requests: the plain versions are vector
    #: ops over the whole batch, so one merged call does the work of many
    prefers_merged_batches = True

    def __init__(self, packed: Optional[bool] = None) -> None:
        #: read through ``packed_enabled`` at each dispatch
        self.packed = packed

    def _apply(self, mat: np.ndarray, data: torch.Tensor) -> torch.Tensor:
        from chunky_bits_tpu_torch.ops import gf_kernel

        return gf_kernel.apply_selected(
            gf_kernel.to_device_matrix(mat, "cpu"), data,
            packed_enabled(self.packed))

    def apply_matrix(self, mat: np.ndarray, shards: np.ndarray) -> np.ndarray:
        return self._apply(mat, as_tensor(shards)).numpy()

    def encode_and_hash(
        self, mat: np.ndarray, shards: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        data = as_tensor(shards)
        parity = self._apply(mat, data).numpy()
        b, k, _ = shards.shape
        digests = np.empty((b, k + parity.shape[1], 32), dtype=np.uint8)
        hash_rows = row_hasher()
        hash_rows(shards, digests[:, :k])
        hash_rows(parity, digests[:, k:])
        return parity, digests


_REGISTRY: dict[str, ErasureBackend] = {}
_REGISTRY_LOCK = threading.Lock()


def register_backend(backend: ErasureBackend) -> None:
    with _REGISTRY_LOCK:
        _REGISTRY[backend.name] = backend


#: the JAX package's backend names that the port runs on its own backends
_ALIASES = {"jax": "cuda"}


def canonical_backend_name(name: Optional[str] = None) -> str:
    """The port's name for a backend as a user or a cluster YAML spells it.

    ``None`` and ``auto`` are the default: ``$CHUNKY_BITS_TORCH_BACKEND``
    if set, else ``cuda`` (never "the CPU if there is no card").  The JAX
    package's names map to the card: ``jax`` to ``cuda`` and
    ``jax:<spec>`` to ``cuda:<spec>``.  ``native`` is the C++ host codec,
    and ``native:N`` the same with N host threads; a count that is not a
    positive integer raises, as in the JAX package."""
    if name is None or name == "auto":
        from chunky_bits_tpu_torch.cluster.tunables import (BACKEND_ENV,
                                                            env_str)

        name = env_str(BACKEND_ENV) or "cuda"
    if name.startswith("native:"):
        spec = name[len("native:"):]
        if not spec.isdigit() or int(spec) < 1:
            raise ErasureError(
                f"bad native thread count {spec!r} (want e.g. native:4)")
    head, sep, spec = name.partition(":")
    if head in _ALIASES:
        return _ALIASES[head] + sep + spec
    return name


def get_backend(name: Optional[str] = None) -> ErasureBackend:
    """Resolve a backend by name, building it lazily.

    ``None`` resolves the default: ``$CHUNKY_BITS_TORCH_BACKEND`` if set,
    else ``cuda``.  ``cuda`` raises ``ErasureError`` without a card.  The
    JAX package's names resolve through ``canonical_backend_name``.
    """
    name = canonical_backend_name(name)
    with _REGISTRY_LOCK:
        if name in _REGISTRY:
            return _REGISTRY[name]
    if name == "numpy":
        backend: ErasureBackend = NumpyBackend()
    elif name == "native" or name.startswith("native:"):
        # ``native:N`` bounds the codec's and the hasher's threads: the
        # knob of hosts shared with other work
        from chunky_bits_tpu_torch.ops.cpu_backend import NativeBackend

        backend = NativeBackend(nthreads=int(name.partition(":")[2] or 0))
        backend.name = name
    elif name == "torch":
        backend = TorchBackend()
    elif name == "cuda":
        from chunky_bits_tpu_torch.ops.cuda_backend import CudaBackend

        backend = CudaBackend()
    elif name == "mesh":
        from chunky_bits_tpu_torch.ops.mesh_backend import MeshBackend

        backend = _build_mesh(name, MeshBackend)
    elif name.startswith("cuda:"):
        from chunky_bits_tpu_torch.parallel.backend import MeshCudaBackend

        backend = _build_mesh(
            name, lambda: MeshCudaBackend(name[len("cuda:"):]))
        # the canonical name and the requested spelling share one entry
        register_backend(backend)
        with _REGISTRY_LOCK:
            _REGISTRY[name] = backend
        return backend
    else:
        raise ErasureError(f"unknown erasure backend {name!r}")
    register_backend(backend)
    return backend


def _build_mesh(name: str, build: Callable[[], ErasureBackend]
                ) -> ErasureBackend:
    """Construct a mesh backend; a mesh the devices cannot hold (a
    ``ValueError`` of ``parallel/mesh.py``) raises ``ErasureError``."""
    try:
        return build()
    except ValueError as err:
        raise ErasureError(f"mesh backend {name!r} unavailable: {err}") \
            from err


def _hash_rows_hashlib(rows: np.ndarray, out: np.ndarray,
                       nthreads: int = 0) -> None:
    """out[..., 32] = sha256 of each row of uint8 rows[..., S], row by row
    under hashlib (``nthreads`` is taken for the native hasher's signature
    and ignored)."""
    for idx in np.ndindex(rows.shape[:-1]):
        out[idx] = np.frombuffer(
            hashlib.sha256(np.ascontiguousarray(rows[idx])).digest(),
            dtype=np.uint8)


def _hash_rows_native(rows: np.ndarray, out: np.ndarray,
                      nthreads: int = 0) -> None:
    """The native engine's ``sha256_rows``, for any ``out`` (a strided one,
    such as the data columns of a digest array, goes through scratch)."""
    from chunky_bits_tpu_torch.ops.cpu_backend import sha256_rows

    if out.flags.c_contiguous:
        sha256_rows(rows, out, nthreads)
        return
    scratch = np.empty(out.shape, dtype=np.uint8)
    sha256_rows(rows, scratch, nthreads)
    out[...] = scratch


_ROW_HASHER: Optional[Callable[..., None]] = None
_ROW_HASHER_LOCK = threading.Lock()


def row_hasher() -> Callable[..., None]:
    """Bulk shard-row hasher ``fn(rows[..., S], out[..., 32],
    nthreads=0)`` on the host: the native SHA-NI engine (GIL-free;
    ``nthreads`` caps its threads, and the host pipeline passes 1 per
    slice), or, where the native codec does not build, a hashlib loop with
    the same digests, as in the JAX package.  ``row_hasher_engine()``
    names the one taken; this is the only place with such a stand-in."""
    global _ROW_HASHER
    if _ROW_HASHER is None:
        with _ROW_HASHER_LOCK:
            if _ROW_HASHER is None:
                try:
                    from chunky_bits_tpu_torch.ops.cpu_backend import \
                        sha256_buf

                    sha256_buf(b"")  # builds the codec now
                    _ROW_HASHER = _hash_rows_native
                except ErasureError:
                    _ROW_HASHER = _hash_rows_hashlib
    return _ROW_HASHER


def row_hasher_engine() -> str:
    """``"native"`` when ``row_hasher()`` is the SHA-NI engine, else
    ``"hashlib"``."""
    return "native" if row_hasher() is _hash_rows_native else "hashlib"


def staged_encode_hash(
    submit: Callable, mat: np.ndarray, data: np.ndarray
) -> Callable[[], tuple[np.ndarray, np.ndarray]]:
    """Stage ``mat ⊗ data`` through a backend's ``submit_apply`` with its
    hashing, and return the function that collects ``(parity[B, r, S],
    digests[B, k+r, 32])``.  The data rows hash on the shared host
    pipeline's workers while the devices work, and each parity block as
    it lands, while later blocks are still in flight."""
    from chunky_bits_tpu_torch.parallel.host_pipeline import (
        get_host_pipeline, join_jobs)

    data = np.ascontiguousarray(data, dtype=np.uint8)
    pipe = get_host_pipeline()
    b, k, _ = data.shape
    digests = np.empty((b, k, 32), dtype=np.uint8)
    parity_digests = np.empty((b, mat.shape[0], 32), dtype=np.uint8)
    jobs = list(pipe.hash_rows_jobs(data, digests))

    def on_block(lo: int, arr: np.ndarray) -> None:
        jobs.extend(pipe.hash_rows_jobs(arr,
                                        parity_digests[lo:lo + arr.shape[0]]))

    ticket = submit(mat, data, on_block=on_block)

    def collect() -> tuple[np.ndarray, np.ndarray]:
        parity = ticket.result()
        join_jobs(jobs)
        return parity, np.concatenate([digests, parity_digests], axis=1)

    return collect


_CODER_CACHE: dict[tuple[int, int, str, str], "ErasureCoder"] = {}
_CODER_LOCK = threading.Lock()

#: the closed set of erasure codes a part may declare (file/chunk.py
#: ``code:`` field): classic Reed-Solomon and the product-matrix MSR
#: regenerating code (ops/pm_msr.py).  Anything else is a foreign writer:
#: readers fail cleanly rather than guess
KNOWN_CODES = ("rs", "pm-msr")


class ErasureCoder:
    """Reed-Solomon codec for one (d, p) geometry — the ``ReedSolomon::new``
    equivalent (reference: src/file/file_part.rs:77).

    Batched variants take uint8 arrays shaped [B, shards, S]; the scalar
    variants mirror the crate's per-part API and are thin wrappers.
    """

    #: wire-format code name; the product-matrix MSR subclass
    #: (ops/pm_msr.py) overrides it
    code = "rs"
    #: whether a backend's fused ``encode_and_hash`` (``parity_rows``
    #: applied to whole chunks) is valid for this code; sub-symbol codes
    #: encode through their own ``encode_batch`` and hash on the host
    supports_fused_ingest = True

    def __init__(self, data: int, parity: int,
                 backend: Optional[ErasureBackend] = None) -> None:
        if data < 1:
            raise ErasureError("data shard count must be >= 1")
        if parity < 0:
            raise ErasureError("parity shard count must be >= 0")
        self.data = data
        self.parity = parity
        self.backend = backend or get_backend()
        self.encode_matrix = matrix.build_encode_matrix(data, parity)
        self.parity_rows = self.encode_matrix[data:]

    def shard_len(self, length: int) -> int:
        """Bytes per shard for a part holding ``length`` meaningful
        bytes — the reference's round-up split
        (src/file/file_part.rs:150-158)."""
        return (length + self.data - 1) // self.data if length > 0 else 0

    def _check_data(self, data: np.ndarray) -> None:
        if data.ndim != 3 or data.shape[1] != self.data:
            raise ErasureError(
                f"expected data shaped [B, {self.data}, S], got {data.shape}")

    # ---- batched API ----

    def encode_batch(self, data: np.ndarray) -> np.ndarray:
        """parity[B, p, S] from data[B, d, S] (crate: ``encode_sep``)."""
        self._check_data(data)
        if self.parity == 0:
            b, _, s = data.shape
            return np.zeros((b, 0, s), dtype=np.uint8)
        return self.backend.apply_matrix(self.parity_rows, data)

    def encode_hash_batch(
        self, data: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray]:
        """Parity plus per-shard content hashes for a batch of parts —
        the ingest step's full compute (reference: encode at
        src/file/file_part.rs:161-165, per-shard sha256 at :185).

        Returns ``(parity[B, p, S], digests[B, d+p, 32])`` with digest
        rows ordered data shards then parity shards.  Backends exposing
        ``encode_and_hash`` do both in one call; otherwise parity comes
        from ``encode_batch`` and the rows are hashed on the host, the
        data rows on the shared host pipeline's workers while the device
        computes parity where the backend dispatches asynchronously
        (``async_dispatch``: the explicit mesh backends).
        """
        self._check_data(data)
        data = np.ascontiguousarray(data)
        fused = (getattr(self.backend, "encode_and_hash", None)
                 if self.supports_fused_ingest else None)
        if fused is not None:
            return fused(self.parity_rows, data)
        digests = np.empty((data.shape[0], self.data + self.parity, 32),
                           dtype=np.uint8)
        hash_rows = row_hasher()
        if getattr(self.backend, "async_dispatch", False):
            from chunky_bits_tpu_torch.parallel.host_pipeline import (
                get_host_pipeline, join_jobs)

            data_digests = np.empty((data.shape[0], self.data, 32),
                                    dtype=np.uint8)
            jobs = get_host_pipeline().hash_rows_jobs(data, data_digests)
            parity = self.encode_batch(data)
            join_jobs(jobs)
            digests[:, :self.data] = data_digests
        else:
            parity = self.encode_batch(data)
            hash_rows(data, digests[:, :self.data])
        hash_rows(parity, digests[:, self.data:])
        return parity, digests

    def encode_hash_batches(
        self, batches: Sequence[np.ndarray]
    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Feed-ahead ingest for several same-geometry batches: one
        ``(parity, digests)`` pair per batch, byte-identical to calling
        ``encode_hash_batch`` per batch.

        On a backend with a ``submit_apply`` staging surface (the mesh
        backends' dispatch window), every batch is staged before any is
        collected, so batch k+1's copies and the host hash stage run
        while batch k computes; each parity block is hashed as it lands.
        Other backends, p = 0 and a code with its own encode math
        (pm-msr's sub-symbol applies) just loop."""
        submit = getattr(self.backend, "submit_apply", None)
        if (submit is None or not self.parity
                or type(self).encode_batch is not ErasureCoder.encode_batch):
            return [self.encode_hash_batch(b) for b in batches]
        collects = []
        for data in batches:
            self._check_data(data)
            collects.append(staged_encode_hash(submit, self.parity_rows,
                                               data))
        return [collect() for collect in collects]

    def reconstruct_batch(
        self, shards: np.ndarray, present: Sequence[int],
        wanted: Sequence[int],
    ) -> np.ndarray:
        """Rebuild ``wanted`` shard rows for a batch sharing one erasure
        pattern.  ``shards[B, d+p, S]`` need only be valid at ``present``
        rows.  Returns [B, len(wanted), S].
        """
        present = sorted(present)
        picked = shards[:, np.array(present[: self.data], dtype=np.intp), :]
        return self.reconstruct_batch_picked(picked, present, wanted)

    def reconstruct_batch_picked(
        self, picked: np.ndarray, present: Sequence[int],
        wanted: Sequence[int],
    ) -> np.ndarray:
        """Like ``reconstruct_batch`` but over shards already gathered in
        decode layout: ``picked[B, d, S]`` holds the rows at
        ``sorted(present)[:d]``, in that order."""
        present = sorted(present)
        dec = matrix.decode_matrix(self.encode_matrix, list(present),
                                   list(wanted))
        return self.backend.apply_matrix(dec, picked)

    # ---- per-part API mirroring the crate ----

    def encode(self, data_shards: Sequence[np.ndarray]) -> list[np.ndarray]:
        """Parity shards for one part's data shards (equal-length rows)."""
        rows = [np.frombuffer(s, dtype=np.uint8)
                if not isinstance(s, np.ndarray) else s
                for s in data_shards]
        if len({len(r) for r in rows}) > 1:
            raise ErasureError("shards must be of equal length")
        stacked = np.stack(rows)[None, ...]
        return list(self.encode_batch(stacked)[0])

    def _reconstruct_impl(
        self, shards: list[Optional[np.ndarray]], data_only: bool
    ) -> list[Optional[np.ndarray]]:
        total = self.data + self.parity
        if len(shards) != total:
            raise ErasureError(
                f"expected {total} shard slots, got {len(shards)}")
        present = [i for i, s in enumerate(shards) if s is not None]
        if len(present) == total:
            return shards
        if len(present) < self.data:
            raise ErasureError(
                f"too few shards present: {len(present)} < {self.data}")
        limit = self.data if data_only else total
        missing = [i for i in range(limit) if shards[i] is None]
        if not missing:
            return shards
        size = len(shards[present[0]])
        stacked = np.zeros((1, total, size), dtype=np.uint8)
        for i in present:
            row = shards[i]
            if not isinstance(row, np.ndarray):
                row = np.frombuffer(row, dtype=np.uint8)
            if len(row) != size:
                raise ErasureError("shards must be of equal length")
            stacked[0, i] = row
        rebuilt = self.reconstruct_batch(stacked, present, missing)[0]
        out = list(shards)
        for row, idx in zip(rebuilt, missing):
            out[idx] = row
        return out

    def reconstruct(
        self, shards: list[Optional[np.ndarray]]
    ) -> list[Optional[np.ndarray]]:
        """Fill every missing shard (crate: ``reconstruct``,
        reference call site src/file/file_part.rs:302-305)."""
        return self._reconstruct_impl(shards, data_only=False)

    def reconstruct_data(
        self, shards: list[Optional[np.ndarray]]
    ) -> list[Optional[np.ndarray]]:
        """Fill missing *data* shards only (crate: ``reconstruct_data``,
        reference call site src/file/file_part.rs:128)."""
        return self._reconstruct_impl(shards, data_only=True)


def get_coder(data: int, parity: int,
              backend: Optional[str] = None,
              code: str = "rs") -> ErasureCoder:
    """Cached coder lookup; matrices are rebuilt once per
    (d, p, backend, code).  ``code`` is the part's wire-format value
    ("rs", or "pm-msr", the product-matrix MSR regenerating code); an
    unknown value raises ErasureError, and so does a geometry pm-msr
    cannot run."""
    if code not in KNOWN_CODES:
        raise ErasureError(
            f"unknown erasure code {code!r} (this reader knows "
            f"{', '.join(KNOWN_CODES)})")
    be = get_backend(backend)
    key = (data, parity, be.name, code)
    with _CODER_LOCK:
        coder = _CODER_CACHE.get(key)
        if coder is None:
            if code == "pm-msr":
                from chunky_bits_tpu_torch.ops.pm_msr import PMMSRCoder

                coder = PMMSRCoder(data, parity, be)
            else:
                coder = ErasureCoder(data, parity, be)
            _CODER_CACHE[key] = coder
        return coder
