"""Multi-device ``mesh`` erasure backend: auto-laid-out sharded dispatch.

The port of ``chunky_bits_tpu/ops/mesh_backend.py``.  ``backend: mesh``
(or ``$CHUNKY_BITS_TORCH_BACKEND=mesh``) puts the erasure plane on every
logical device (``utils/virtualmesh.visible_devices``: one per CUDA device,
or ``$CHUNKY_BITS_TORCH_VIRTUAL_DEVICES`` of them on ``cuda:0``), choosing a
layout per dispatch, where ``cuda:dp2,tp4`` (``parallel/backend.py``) pins
one mesh for the process.  Each staged ``[B, d, S]`` batch is sharded:

* batch-parallel ``('dp', 'sp')`` by default: parts over ``dp`` and, when
  the batch alone cannot fill the mesh, shard bytes over the leftover
  ``sp`` axis (K1 on each device);
* wide-stripe ``('dp', 'tp')`` when the stripe is wide (``k >=
  WIDE_STRIPE_MIN_K``) and the batch cannot cover the devices: the GF
  contraction splits over ``tp``, each rank runs K2 and the group sums
  its int16 partials and packs once (``parallel/mesh.py``).

``WIDE_STRIPE_MIN_K``, ``LANE``, ``Layout`` and ``plan_layout`` are the JAX
package's, unchanged: the numbers are a contract its tests pin, so the
``sp`` padding to ``minor * LANE`` bytes stays (padding copies the batch and
is sliced off after; GF transforms are column-wise, so it never leaks).

Dispatch rides a :class:`DispatchPipeline`: each block is issued on the
logical devices' streams and collected later, so block k+1's copies and
the host hash stage overlap block k's compute and block k-1's copy back,
with at most ``depth`` blocks in flight.  A batch is walked in blocks of
whole ``dp`` groups under ``max_block_bytes`` of device memory for the
window (inputs, outputs and, for ``tp``, every rank's int16
accumulators).  ``submit_apply`` is the feed-ahead surface the ingest path
stages whole batches through (``ErasureCoder.encode_hash_batches``).

Not ported, on purpose as for the ``cuda`` backend: ``await_device_init``,
``run_bounded_dispatch``, ``_degrade``, ``_cpu_fallback`` and buffer
donation.  There is no CPU recompute: a failed build, launch or
materialization raises ``ErasureError`` (through the ticket for work
already in the window).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np

from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops.backend import ErasureBackend
from chunky_bits_tpu_torch.ops.dispatch_pipeline import DispatchPipeline
from chunky_bits_tpu_torch.utils.virtualmesh import LogicalDevice

#: contraction-split threshold: stripes at least this wide take the
#: ('dp', 'tp') layout when the batch alone cannot fill the mesh
WIDE_STRIPE_MIN_K = 16

#: per-device byte-slice alignment for the 'sp' axis (the JAX package's
#: contract, kept: slices stay whole multiples of 64 bytes)
LANE = 64


@dataclass(frozen=True)
class Layout:
    """One dispatch's mesh layout: ``('dp', 'tp')`` when ``wide`` else
    ``('dp', 'sp')``; ``minor`` is the tp/sp extent and ``pad_s`` the byte
    padding keeping per-device slices LANE-aligned."""

    wide: bool
    dp: int
    minor: int
    pad_s: int


def _divisors_desc(n: int) -> list[int]:
    return [d for d in range(n, 0, -1) if n % d == 0]


def plan_layout(n: int, b: int, k: int, s: int) -> Layout:
    """Pick the mesh layout for one ``[b, k, s]`` dispatch over ``n``
    devices.  Batch-parallel wants ``dp`` as large as the batch allows;
    the leftover axis goes to the stripe (``tp``, wide stripes only) or to
    shard bytes (``sp``, padded to ``minor * LANE``)."""
    b = max(b, 1)
    dp = next(d for d in _divisors_desc(n) if d <= b)
    minor = n // dp
    if minor == 1:
        return Layout(False, dp, 1, 0)
    if k >= WIDE_STRIPE_MIN_K and k % minor == 0:
        return Layout(True, dp, minor, 0)
    return Layout(False, dp, minor, (-s) % (minor * LANE))


def _dispatch_error(backend: ErasureBackend,
                    err: Exception) -> ErasureError:
    if isinstance(err, ErasureError):
        return err
    return ErasureError(f"{backend.name} dispatch failed: {err}")


class _MeshTicket:
    """One ``submit_apply`` call's handle: the un-materialized blocks of a
    ``[B, k, S]`` batch.  ``result()`` collects them FIFO through the
    owning backend's pipeline and fires ``on_block`` per block."""

    __slots__ = ("_backend", "_entries", "_spans", "_on_block", "_s",
                 "_value")

    def __init__(self, backend: "ShardedBackend", entries: list,
                 spans: list[tuple[int, int]],
                 on_block: Optional[Callable[[int, np.ndarray], None]],
                 s: int, value: Optional[np.ndarray] = None) -> None:
        self._backend = backend
        self._entries = entries
        self._spans = spans
        self._on_block = on_block
        self._s = s
        self._value = value

    def result(self) -> np.ndarray:
        if self._value is not None:
            return self._value
        pipe = self._backend.pipeline
        outs: list[np.ndarray] = []
        for (lo, rows), entry in zip(self._spans, self._entries):
            try:
                arr = pipe.result(entry)
            except Exception as err:  # a CUDA fault, or a poisoned window
                raise _dispatch_error(self._backend, err) from err
            if arr.shape[2] != self._s:
                arr = np.ascontiguousarray(arr[:, :, :self._s])
            if self._on_block is not None:
                # lint: clock-escape-ok times REAL host-side work for
                # the overlap-proof counters (bench config 17); real
                # work completes at zero virtual width under sim
                t0 = time.perf_counter()
                self._on_block(lo, arr)
                if pipe.inflight:
                    # lint: clock-escape-ok same real host interval
                    pipe.note_host_overlap(time.perf_counter() - t0)
            outs.append(arr)
        self._value = (outs[0] if len(outs) == 1
                       else np.concatenate(outs, axis=0))
        self._entries = self._spans = []
        return self._value


class ShardedBackend(ErasureBackend):
    """What both mesh backends share: the dispatch window and the block
    walk.  Subclasses choose the layout of each dispatch (``_layout``)."""

    #: the generic ingest path overlaps host hashing with the sharded
    #: device dispatch (``ErasureCoder.encode_hash_batch``)
    async_dispatch = True

    #: batcher groups route through the feed-ahead ``submit_apply``
    prefers_merged_batches = True

    #: device bytes the window may hold (``depth + 1`` blocks while a
    #: submit is admitted): inputs, outputs and the tp accumulators, whose
    #: int16 per output bit make a config-5 part ~1.6 GiB
    max_block_bytes = 8 << 30

    def __init__(self, depth: Optional[int] = None,
                 devices: Optional[Sequence[LogicalDevice]] = None) -> None:
        if devices is None:
            from chunky_bits_tpu_torch.utils.virtualmesh import visible_devices

            devices = visible_devices()
        self.devices = list(devices)
        self.n_devices = len(self.devices)
        self.pipeline = DispatchPipeline(depth=depth,
                                         name=f"{self.name} dispatch")
        self._meshes: dict[tuple[bool, int, int], object] = {}
        self._mesh_lock = threading.Lock()
        if self.devices[0].stream is not None:
            # build and load every kernel now: a failed build fails
            # backend resolution
            from chunky_bits_tpu_torch.ops import _build

            _build.load("gf_acc")

    def _layout(self, b: int, k: int, s: int) -> Layout:
        raise NotImplementedError

    def _mesh_for(self, lay: Layout):
        from chunky_bits_tpu_torch.parallel import mesh as mesh_mod

        key = (lay.wide, lay.dp, lay.minor)
        with self._mesh_lock:
            mesh = self._meshes.get(key)
            if mesh is None:
                n = lay.dp * lay.minor
                if lay.wide:
                    mesh = mesh_mod.make_stripe_mesh(
                        n, dp=lay.dp, tp=lay.minor, devices=self.devices)
                else:
                    mesh = mesh_mod.make_mesh(
                        n, dp=lay.dp, sp=lay.minor, devices=self.devices)
                self._meshes[key] = mesh
            return mesh

    def plan(self, b: int, r: int, k: int, s: int) -> tuple[Layout, int]:
        """The layout of a ``[b, k, s]`` dispatch of an ``[r, k]`` matrix
        and its parts per block: whole ``dp`` groups, as many as the
        window's share of ``max_block_bytes`` holds (at least one group)."""
        lay = self._layout(b, k, s)
        width = s + lay.pad_s
        per_item = k * width + r * width
        if lay.wide:
            per_item += lay.minor * 16 * r * width  # int16 per output bit
        budget = self.max_block_bytes // (self.pipeline.depth + 1)
        block = max(lay.dp, budget // max(per_item, 1) // lay.dp * lay.dp)
        return lay, block

    def submit_apply(self, mat: np.ndarray, shards: np.ndarray,
                     on_block: Optional[Callable[[int, np.ndarray],
                                                 None]] = None
                     ) -> _MeshTicket:
        """Stage one ``[B, k, S]`` matrix apply into the dispatch window
        and return a ticket; the devices start on it while the caller
        stages more.  ``on_block(lo, arr)`` fires per block during
        ``result()``, on the collecting thread."""
        from chunky_bits_tpu_torch.parallel import mesh as mesh_mod

        mat = np.ascontiguousarray(mat, dtype=np.uint8)
        shards = np.asarray(shards, dtype=np.uint8)
        b, k, s = shards.shape
        r = mat.shape[0]
        if r == 0 or b == 0 or s == 0:
            out = np.zeros((b, r, s), dtype=np.uint8)
            if on_block is not None and b:
                on_block(0, out)
            return _MeshTicket(self, [], [], None, s, value=out)
        lay, block = self.plan(b, r, k, s)
        if lay.wide and k % lay.minor:
            raise ErasureError(
                f"stripe width {k} not divisible by tp={lay.minor}")
        mesh = self._mesh_for(lay)
        issue = mesh_mod.issue_wide if lay.wide else mesh_mod.issue_sharded
        padded = (np.pad(shards, ((0, 0), (0, 0), (0, lay.pad_s)))
                  if lay.pad_s else shards)
        entries: list = []
        spans: list[tuple[int, int]] = []
        for lo in range(0, b, block):
            blk = padded[lo:lo + block]
            try:
                entries.append(self.pipeline.submit(
                    lambda blk=blk: issue(mesh, mat, blk),
                    lambda handle: handle.materialize()))
            except Exception as err:  # a failed build, launch or copy
                raise _dispatch_error(self, err) from err
            spans.append((lo, blk.shape[0]))
        return _MeshTicket(self, entries, spans, on_block, s)

    def apply_matrix(self, mat: np.ndarray, shards: np.ndarray,
                     on_block: Optional[Callable[[int, np.ndarray],
                                                 None]] = None
                     ) -> np.ndarray:
        """Sharded dispatch, blocking: stage through the window and
        collect.  Byte-identical to every other backend."""
        return self.submit_apply(mat, shards, on_block=on_block).result()


class MeshBackend(ShardedBackend):
    """Erasure math sharded over every logical device, laid out per
    dispatch by ``plan_layout``, fed through the dispatch window."""

    name = "mesh"

    def _layout(self, b: int, k: int, s: int) -> Layout:
        return plan_layout(self.n_devices, b, k, s)

    def encode_and_hash(self, mat: np.ndarray, shards: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Overlapped ingest: the mesh computes parity while the shared
        host pipeline hashes the data rows, and each parity block is
        hashed as it lands while later blocks are in flight.  The digests
        are hashlib's, row for row."""
        from chunky_bits_tpu_torch.ops.backend import staged_encode_hash

        return staged_encode_hash(self.submit_apply, mat, shards)()
