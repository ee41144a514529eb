"""Mesh-sharded erasure math: the multi-device compute plane.

The port of ``chunky_bits_tpu/parallel/mesh.py``.  A ``Mesh`` names the two
axes of a grid of logical devices (``utils/virtualmesh.py``: a torch device
and a stream each, so several can share one card):

* ``dp`` - the part-batch axis: each device encodes its own slice of parts.
* ``sp`` - the shard-byte axis: GF(2^8) transforms are element-wise across
  bytes, so one stripe's byte range splits across devices with no halo.
* ``tp`` - the stripe axis (wide stripes, BASELINE.md config 5: d=20 p=6):
  the contraction of the GF product splits, each device holds d/tp data
  shards and computes int16 bit-plane popcounts over them
  (``gf_kernel.accumulate``, K2); the partials of a ``tp`` group are
  reduced and packed once on the group's first device
  (``gf_kernel.reduce_pack``, one kernel reading each partial once).
  Exact, since GF(2^8) addition is XOR: the parity of a count's sum is the
  XOR of the partials' parities.

The per-device function follows the tensors, with no ``impl`` switch: the
kernels for CUDA tensors, their plain versions for CPU tensors (the
wrappers in ``ops/gf_kernel.py`` decide).  ``dp``/``sp`` run
``gf_kernel.apply_selected`` (K1, or K3 where ``packed`` is on and the
geometry is inside its gate); ``tp`` runs ``accumulate`` with each rank's
own column block of the table (the table is per byte column, so the JAX
package's interleaved ``_host_bitmajor_blocks`` has no counterpart).

On CUDA devices a dispatch is issued without waiting on the card
(``issue_sharded``/``issue_wide``): each device's slice is copied into
pinned memory, moved to the card on the device's stream, computed there,
and copied back into pinned memory, and an event is recorded; the
``MeshDispatch`` holds every buffer until ``materialize()`` has waited for
the events, so no buffer is freed or reused while a stream still uses it.
The blocking functions (``sharded_apply`` and the rest) issue and
materialize at once.  Inputs are numpy arrays, read and never written;
outputs are numpy arrays.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from chunky_bits_tpu_torch.ops import gf_kernel
from chunky_bits_tpu_torch.utils.virtualmesh import LogicalDevice


class Mesh:
    """Named axes over a 2-D grid of logical devices (the counterpart of
    ``jax.sharding.Mesh``): ``devices[a, b]`` is a ``LogicalDevice``,
    ``shape`` maps each axis name to its extent."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device grid, axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, devices.shape))

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}, {self.devices.flat[0].device})"


def _make_mesh_2d(n_devices: Optional[int], first: Optional[int],
                  first_name: str, second: Optional[int], second_name: str,
                  devices: Optional[Sequence[LogicalDevice]] = None) -> Mesh:
    if devices is None:
        from chunky_bits_tpu_torch.utils.virtualmesh import visible_devices

        devices = visible_devices()
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(
            f"mesh needs {n} devices, only {len(devices)} visible")
    devices = list(devices)[:n]
    if first is None and second is None:
        second = 1
        first = n
    elif first is None:
        first = n // second
    elif second is None:
        second = n // first
    if first * second != n:
        raise ValueError(
            f"{first_name}({first}) * {second_name}({second}) "
            f"!= devices({n})")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(first, second), (first_name, second_name))


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              sp: Optional[int] = None,
              devices: Optional[Sequence[LogicalDevice]] = None) -> Mesh:
    """Build a ('dp', 'sp') mesh over the first n of ``devices`` (default:
    ``visible_devices()``)."""
    return _make_mesh_2d(n_devices, dp, "dp", sp, "sp", devices=devices)


def make_stripe_mesh(n_devices: Optional[int] = None,
                     dp: Optional[int] = None, tp: Optional[int] = None,
                     devices: Optional[Sequence[LogicalDevice]] = None
                     ) -> Mesh:
    """Build a ('dp', 'tp') mesh for wide-stripe (contraction-sharded)
    encode/decode; ``tp`` must divide the stripe's data-shard count."""
    return _make_mesh_2d(n_devices, dp, "dp", tp, "tp", devices=devices)


@functools.lru_cache(maxsize=256)
def _table(mat_bytes: bytes, r: int, k: int, device: str) -> torch.Tensor:
    """The kernels' ``[R, K, 8]`` operand for one GF matrix on one device,
    kept for later dispatches (a dispatch holds its own reference, so an
    eviction never frees a table in use)."""
    mat = np.frombuffer(mat_bytes, dtype=np.uint8).reshape(r, k)
    return gf_kernel.to_device_matrix(mat, device)


def _device_table(mat: np.ndarray, ld: LogicalDevice) -> torch.Tensor:
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    return _table(mat.tobytes(), mat.shape[0], mat.shape[1], str(ld.device))


def _spans(n: int, parts: int) -> list[tuple[int, int]]:
    """``n`` items over ``parts`` ranks, as even as possible."""
    return [(i * n // parts, (i + 1) * n // parts) for i in range(parts)]


def _host_tensor(shards: np.ndarray) -> torch.Tensor:
    from chunky_bits_tpu_torch.ops.backend import as_tensor

    return as_tensor(np.asarray(shards))


class MeshDispatch:
    """One issued sharded dispatch: output pieces, the events that finish
    them, and every buffer the streams still use.  ``materialize()``
    waits and assembles the host result ``[B, R, S]``."""

    __slots__ = ("shape", "pieces", "events", "keep", "sums", "value")

    def __init__(self, shape: tuple[int, int, int]) -> None:
        self.shape = shape
        #: ((part lo, hi), (byte lo, hi), host or pinned tensor)
        self.pieces: list[tuple[tuple[int, int], tuple[int, int],
                                torch.Tensor]] = []
        self.events: list = []
        self.keep: list = []
        #: per-device int64 sums of the output (encode_step's checksum)
        self.sums: list[torch.Tensor] = []
        self.value: Optional[np.ndarray] = None

    def materialize(self) -> np.ndarray:
        if self.value is None:
            for ev in self.events:
                ev.synchronize()
            out = np.empty(self.shape, dtype=np.uint8)
            for (plo, phi), (slo, shi), piece in self.pieces:
                out[plo:phi, :, slo:shi] = piece.numpy()
            self.value = out
            self.events, self.keep, self.pieces = [], [], []
        return self.value

    def checksum(self) -> int:
        """The uint32 sum of every output byte, wrapping (summed in int64
        and masked: torch's uint32 arithmetic is not on every build)."""
        self.materialize()
        return int(sum(int(s) for s in self.sums)) & 0xFFFFFFFF


def _stage(ld: LogicalDevice, src: torch.Tensor, d: MeshDispatch
           ) -> torch.Tensor:
    """``src`` (a host view) on ``ld``: the view itself on a CPU device,
    else a pinned copy moved to the card on the device's stream."""
    if ld.stream is None:
        return src
    pin = torch.empty(src.shape, dtype=torch.uint8, pin_memory=True)
    pin.copy_(src)
    x = torch.empty(src.shape, dtype=torch.uint8, device=ld.device)
    x.copy_(pin, non_blocking=True)
    d.keep += [pin, x]
    return x


def _unstage(ld: LogicalDevice, y: torch.Tensor, d: MeshDispatch
             ) -> torch.Tensor:
    """``y`` brought back to pinned host memory on the device's stream, an
    event recorded after it (CPU tensors are returned as they are)."""
    if ld.stream is None:
        return y
    pin = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
    pin.copy_(y, non_blocking=True)
    ev = torch.cuda.Event()
    ev.record(ld.stream)
    d.keep.append(y)
    d.events.append(ev)
    return pin


def issue_sharded(mesh: Mesh, mat: np.ndarray, shards, *,
                  packed: Optional[bool] = None,
                  checksum: bool = False) -> MeshDispatch:
    """Issue ``mat ⊗ shards`` with B split over 'dp' and S over 'sp'; each
    device runs ``apply_selected`` on its slice.  Uneven splits are taken
    as they come (a device with an empty slice launches nothing)."""
    from chunky_bits_tpu_torch.ops.backend import packed_enabled

    src = _host_tensor(shards)
    b, k, s = src.shape
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    if mat.ndim != 2 or mat.shape[1] != k:
        raise ValueError(f"matrix {mat.shape} does not take {k} shard rows")
    use_packed = packed_enabled(packed)
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    d = MeshDispatch((b, mat.shape[0], s))
    for i, (plo, phi) in enumerate(_spans(b, dp)):
        for j, (slo, shi) in enumerate(_spans(s, sp)):
            if phi == plo or shi == slo:
                continue
            ld = mesh.devices[i, j]
            with ld.context():
                table = _device_table(mat, ld)
                x = _stage(ld, src[plo:phi, :, slo:shi], d)
                y = gf_kernel.apply_selected(table, x, use_packed)
                if checksum:
                    d.sums.append(y.sum(dtype=torch.int64))
                d.keep.append(table)
                d.pieces.append(((plo, phi), (slo, shi),
                                 _unstage(ld, y, d)))
    return d


def issue_wide(mesh: Mesh, mat: np.ndarray, shards) -> MeshDispatch:
    """Issue ``mat ⊗ shards`` with B split over 'dp' and the K (stripe)
    axis over 'tp': each rank accumulates int16 popcounts over its K/tp
    rows (K2), the group's first device reduces and packs the partials
    in one kernel once they are ready (``.to()`` brings them over from
    another GPU; on one card it is a no-op)."""
    src = _host_tensor(shards)
    b, k, s = src.shape
    tp = mesh.shape["tp"]
    mat = np.ascontiguousarray(mat, dtype=np.uint8)
    r = mat.shape[0]
    if mat.ndim != 2 or mat.shape[1] != k:
        raise ValueError(f"matrix {mat.shape} does not take {k} shard rows")
    if k % tp != 0:
        raise ValueError(f"stripe width {k} not divisible by tp={tp}")
    kb = k // tp
    d = MeshDispatch((b, r, s))
    for i, (plo, phi) in enumerate(_spans(b, mesh.shape["dp"])):
        if phi == plo:
            continue
        partials = []
        for t in range(tp):
            ld = mesh.devices[i, t]
            with ld.context():
                table = _device_table(mat[:, t * kb:(t + 1) * kb], ld)
                x = _stage(ld, src[plo:phi, t * kb:(t + 1) * kb], d)
                acc = gf_kernel.accumulate(table, x)
                ready = None
                if ld.stream is not None:
                    ready = torch.cuda.Event()
                    ready.record(ld.stream)
                d.keep += [table, acc]
                partials.append((ld, acc, ready))
        lead = partials[0][0]
        with lead.context():
            accs = [partials[0][1]]
            for ld, acc, ready in partials[1:]:
                if ready is not None:
                    lead.stream.wait_event(ready)
                    with ld.context():  # a cross-GPU copy orders both streams
                        acc = acc.to(lead.device, non_blocking=True)
                    d.keep.append(acc)
                accs.append(acc)
            y = gf_kernel.reduce_pack(accs)
            d.pieces.append(((plo, phi), (0, s), _unstage(lead, y, d)))
    return d


def sharded_apply(mesh: Mesh, mat: np.ndarray, shards, *,
                  packed: Optional[bool] = None) -> np.ndarray:
    """out[B, R, S] = mat ⊗ shards with B split over 'dp' and S over 'sp'.

    Parts are independent and the transform is element-wise over S, so
    both splits need no collective; the host gathers the pieces.
    ``packed`` selects K3 where its gate allows (None: the env knob)."""
    return issue_sharded(mesh, mat, shards, packed=packed).materialize()


def encode_step_sharded(mesh: Mesh, encode_matrix: np.ndarray, data, *,
                        packed: Optional[bool] = None
                        ) -> tuple[np.ndarray, int]:
    """One sharded ingest step: parity for every part plus the global
    checksum, the uint32 sum of the parity bytes (wrapping), summed from
    each device's share.  ``data`` is uint8 [B, d, S]; returns
    (parity [B, p, S], checksum)."""
    d = encode_matrix.shape[1]
    parity_rows = np.ascontiguousarray(encode_matrix[d:], dtype=np.uint8)
    disp = issue_sharded(mesh, parity_rows, data, packed=packed,
                         checksum=True)
    return disp.materialize(), disp.checksum()


def wide_apply_sharded(mesh: Mesh, mat: np.ndarray, shards) -> np.ndarray:
    """out[B, R, S] = mat ⊗ shards with B over 'dp' and the K (stripe)
    axis over 'tp'.  ``mat`` is a GF(2^8) matrix [R, K] (parity rows for
    encode, host-inverted rows for decode).  'tp' must divide K."""
    return issue_wide(mesh, mat, shards).materialize()


def encode_wide_sharded(mesh: Mesh, encode_matrix: np.ndarray,
                        data) -> np.ndarray:
    """Wide-stripe parity: data uint8 [B, d, S] with d split over 'tp'
    (and B over 'dp') -> parity uint8 [B, p, S]."""
    d = encode_matrix.shape[1]
    parity_rows = np.ascontiguousarray(encode_matrix[d:], dtype=np.uint8)
    return wide_apply_sharded(mesh, parity_rows, data)
