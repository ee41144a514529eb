"""Coalesce concurrent erasure-codec calls into batched device dispatches.

The reference runs one codec call per part on the blocking pool — encode at
src/file/file_part.rs:161-165, reconstruct at :128,302-305.  That shape
wastes a TPU: dispatch overhead dominates small calls, while the kernel
itself is throughput-bound and loves batch.  Concurrency that already
exists in the pipelines (resilver keeps 10 parts in flight
src/file/file_reference.rs:110, reads prefetch 5 src/file/reader.rs:96,
the gateway serves many PUTs at once) is turned into batch here: whatever
requests are in flight at the same moment are grouped by compatible shape
and executed as one ``[B, ...]`` dispatch.

A lone request is dispatched immediately.  How many dispatches of one
group may run at once follows the backend: one that runs one walk at a
time declares ``concurrent_dispatches`` (``cuda``: 1), and a group's
requests that arrive while that many of its dispatches are running are
held, then leave together as the next dispatch when one completes.  So
batching emerges from concurrency without added latency, and the queue
sits here, where requests merge, not on the backend's lock, where they
cannot.  A backend that declares nothing takes every group as it comes.

The port of ``chunky_bits_tpu/ops/batching.py`` with the same keys, merge
policy and ``submit_apply`` feed-ahead route (backends with a dispatch
window, the mesh backends, get a group's batches staged one after another
through ``ErasureCoder.encode_hash_batches`` instead of one concatenate).
"""

from __future__ import annotations

import asyncio
from typing import Optional, Sequence

import numpy as np

from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.ops.backend import get_backend, get_coder


class _GroupItemError:
    """Per-item failure marker in a ``_run_group`` result list: lets a
    group deliver a mix of results and exceptions, so one bad batch in
    an UNMERGED group fails only its own waiter (a merged dispatch has
    no such boundary — every contributing waiter shares its fate)."""

    __slots__ = ("err",)

    def __init__(self, err: BaseException):
        self.err = err


def _host_buffer(coder, shape: tuple) -> np.ndarray:
    """Host memory for a batch that a dispatch fills: the backend's
    ``host_buffer`` where it has one (``cuda``: page-locked, so its walk
    copies the batch to the card as it is, with no staging copy)."""
    alloc = getattr(coder.backend, "host_buffer", None)
    if alloc is None:
        return np.empty(shape, dtype=np.uint8)
    return alloc(shape)


class _CoalescingBatcher:
    """Group concurrent requests by key and dispatch each group once.

    Instances are per-pipeline (one read stream, one resilver run, one
    cluster ingest scope) and must be used from a single event loop.
    Subclasses implement ``_run_group(key, payloads) -> results`` (called
    in a worker thread).  The ``_queued``/``_running``/``_task``/
    ``_inflight`` bookkeeping is lock-free because it never leaves the
    owning loop's thread.
    """

    def __init__(self, backend: Optional[str] = None, max_batch: int = 128):
        self.backend = backend
        self.max_batch = max_batch
        #: per key, ``(payload, future)`` of the requests not yet
        #: dispatched, oldest first
        self._queued: dict[tuple, list] = {}
        #: per key, its dispatches in flight
        self._running: dict[tuple, int] = {}
        #: the backend's ``concurrent_dispatches`` (None: no limit), looked
        #: up by the first drain
        self._limit: Optional[int] = None
        self._limit_known = False
        self._task: Optional[asyncio.Task] = None
        self._inflight: set[asyncio.Task] = set()
        #: codec dispatches issued (merged batches count once; unmerged
        #: CPU batches count each)
        self.dispatches = 0
        #: coalesced groups executed (one per _run_group call) — the
        #: request-grouping factor independent of the merge policy
        self.groups = 0
        #: requests that waited for an in-flight dispatch of their key
        #: instead of starting one (backends that declare
        #: ``concurrent_dispatches``)
        self.held = 0

    async def _submit(self, key: tuple, payload):
        fut = asyncio.get_running_loop().create_future()
        if (self._limit is not None
                and self._running.get(key, 0) >= self._limit):
            self.held += 1
        self._queued.setdefault(key, []).append((payload, fut))
        if self._task is None or self._task.done():
            self._task = asyncio.create_task(self._drain())
        # resolved (result or exception) by _dispatch in every outcome
        # lint: unbounded-await-ok resolved (result or exception) by
        # _dispatch in every outcome, and the device work underneath
        # raises on a failed launch instead of parking
        return await fut

    def _backend_limit(self) -> Optional[int]:
        return getattr(get_backend(self.backend), "concurrent_dispatches",
                       None)

    async def _drain(self) -> None:
        # Yield once so callers scheduled in the same tick can enqueue
        # before the first dispatch.
        await asyncio.sleep(0)
        if not self._limit_known:
            # once, off the loop: the lookup may build the backend
            self._limit_known = True
            try:
                self._limit = await asyncio.to_thread(self._backend_limit)
            # lint: broad-except-ok a backend that cannot be built fails
            # every dispatch, which delivers the error to its waiters
            except Exception:
                pass
        for key in list(self._queued):
            self._start(key)

    def _start(self, key: tuple) -> None:
        """Dispatch ``key``'s queued requests, up to ``max_batch`` a
        dispatch, while the backend's limit allows.  Distinct keys are
        independent work, and nothing waits on anyone else's group: each
        dispatch is its own task (no barrier — a slow group must not stall
        either the other groups' results or the next round of arrivals)."""
        queue = self._queued.get(key)
        while queue and (self._limit is None
                         or self._running.get(key, 0) < self._limit):
            group = queue[:self.max_batch]
            del queue[:self.max_batch]
            self._running[key] = self._running.get(key, 0) + 1
            task = asyncio.create_task(self._dispatch(key, group))
            self._inflight.add(task)
            task.add_done_callback(self._inflight.discard)
        if not queue:
            self._queued.pop(key, None)

    async def _dispatch(self, key: tuple, group: list) -> None:
        self.groups += 1
        try:
            results = await asyncio.to_thread(
                self._run_group, key, [g[0] for g in group])
        # delivered to every waiter via fut.set_exception;
        # CancelledError additionally re-raised
        # lint: broad-except-ok delivered to every waiter via
        # fut.set_exception; CancelledError additionally re-raised
        except BaseException as err:
            for _, fut in group:
                if not fut.done():
                    fut.set_exception(err)
            if isinstance(err, asyncio.CancelledError):
                raise
        else:
            for (_, fut), res in zip(group, results):
                if not fut.done():
                    if isinstance(res, _GroupItemError):
                        fut.set_exception(res.err)
                    else:
                        fut.set_result(res)
        finally:
            # the requests held behind this dispatch leave as the next one
            self._running[key] -= 1
            if not self._running[key]:
                del self._running[key]
            self._start(key)

    async def aclose(self) -> None:
        """Drain: await the pending collection task and every in-flight
        dispatch, so owners tearing down (end of a read stream, resilver
        run, or event loop) never abandon waiter futures mid-flight.
        Requests held behind a dispatch leave as its successor, which is
        in flight before that dispatch ends, so they are drained too.
        Dispatch errors are delivered to their waiters, not raised here.

        A finished dispatch stays in ``_inflight`` until its queued
        ``discard`` callback runs, and ``gather`` over tasks that are all
        done completes without yielding to the loop (Python 3.12), so it
        would never let that callback run: only tasks still running are
        awaited, and when every task found is done the loop gets one
        turn instead."""
        while True:
            tasks = set(self._inflight)
            if self._task is not None and not self._task.done():
                tasks.add(self._task)
            if not tasks:
                return
            running = [t for t in tasks if not t.done()]
            if running:
                await asyncio.gather(*running, return_exceptions=True)
            else:
                await asyncio.sleep(0)

    def _run_group(self, key: tuple, payloads: list) -> list:
        raise NotImplementedError


class ReconstructBatcher(_CoalescingBatcher):
    """Batched decode front-end for the read and resilver paths.

    Groups by (geometry, erasure pattern, shard length): the parts of one
    file degraded by the same node loss share a pattern and rebuild in one
    ``[B, d+p, S]`` dispatch through ``ErasureCoder.reconstruct_batch``.
    """

    async def reconstruct(
        self, d: int, p: int, arrays: Sequence[Optional[np.ndarray]],
        data_only: bool = False, code: str = "rs",
    ) -> list[Optional[np.ndarray]]:
        """Async equivalent of ``ErasureCoder.reconstruct`` /
        ``reconstruct_data`` (crate call sites file_part.rs:128,302-305):
        fill the ``None`` rows of ``arrays`` (all d+p slots, data first).
        ``code`` is the part's wire-format erasure code — requests only
        coalesce within a code (the decode matrices differ).
        """
        total = d + p
        if len(arrays) != total:
            raise ErasureError(
                f"expected {total} shard slots, got {len(arrays)}")
        arrays = list(arrays)
        present = tuple(i for i, a in enumerate(arrays) if a is not None)
        if len(present) == total:
            return arrays
        if len(present) < d:
            raise ErasureError(
                f"too few shards present: {len(present)} < {d}")
        limit = d if data_only else total
        wanted = tuple(i for i in range(limit) if arrays[i] is None)
        if not wanted:
            return arrays
        size = len(arrays[present[0]])
        # Validate before coalescing: a malformed request must fail alone,
        # not poison the whole group it would have joined.
        for i in present[1:]:
            if len(arrays[i]) != size:
                raise ErasureError("shards must be of equal length")
        key = (d, p, present, wanted, size, code)
        return await self._submit(key, arrays)

    def _run_group(self, key: tuple, requests: list[list]) -> list[list]:
        d, p, present, wanted, size, code = key
        self.dispatches += 1
        coder = get_coder(d, p, self.backend, code)
        # stack straight into decode layout (the first d present rows,
        # ascending) — one gather pass instead of a full [B, d+p, S]
        # scatter followed by reconstruct_batch's row-pick copy
        use = sorted(present)[:d]
        picked = _host_buffer(coder, (len(requests), d, size))
        for bi, arrays in enumerate(requests):
            for j, i in enumerate(use):
                picked[bi, j] = arrays[i]
        rebuilt = coder.reconstruct_batch_picked(picked, list(present),
                                                 list(wanted))
        out: list[list] = []
        for bi, arrays in enumerate(requests):
            filled = list(arrays)
            for wi, i in enumerate(wanted):
                filled[i] = rebuilt[bi, wi]
            out.append(filled)
        return out


class EncodeHashBatcher(_CoalescingBatcher):
    """Batched encode+hash front-end for the ingest path.

    One large file already batches its own parts (writer.py staging); this
    batcher coalesces *across* concurrent writes — the many-small-objects
    regime (e.g. parallel HTTP-gateway PUTs), where each write has a
    single sub-batch part and per-dispatch overhead would dominate.
    Grouped by (d, p, shard length).

    Whether a group's batches are additionally merged into one
    ``[ΣB, d, S]`` dispatch follows the backend's
    ``prefers_merged_batches`` policy (see ``_run_group``): ``cuda`` and
    ``torch`` merge, the mesh backends stage the batches through
    ``submit_apply``, ``numpy`` runs the group's batches back-to-back
    unmerged.

    ``host_pipeline`` (a ``parallel.host_pipeline.HostPipeline``) runs
    each dispatch's host compute through the shared multi-core executor
    instead of one direct ``coder.encode_hash_batch`` call; None keeps the
    direct call.
    """

    def __init__(self, backend: Optional[str] = None, max_batch: int = 128,
                 host_pipeline: Optional[object] = None):
        super().__init__(backend, max_batch)
        self.host_pipeline = host_pipeline

    async def encode_hash(
        self, d: int, p: int, stacked: np.ndarray, code: str = "rs",
    ) -> tuple[np.ndarray, np.ndarray]:
        """Async equivalent of ``ErasureCoder.encode_hash_batch`` for one
        staged part batch ``stacked[B, d, S]``: returns
        ``(parity[B, p, S], digests[B, d+p, 32])``.  ``code`` selects
        the erasure code; batches only merge within a code."""
        if stacked.ndim != 3 or stacked.shape[1] != d:
            raise ErasureError(
                f"expected stacked [B, {d}, S], got {stacked.shape}")
        b, _, size = stacked.shape
        if b == 0:
            return (np.zeros((0, p, size), dtype=np.uint8),
                    np.zeros((0, d + p, 32), dtype=np.uint8))
        key = (d, p, size, code)
        return await self._submit(key, stacked)

    def _encode(self, coder, stacked: np.ndarray):
        """The per-dispatch codec call for one (possibly merged) batch."""
        if self.host_pipeline is not None:
            return self.host_pipeline.encode_hash_sync(coder, stacked)
        return coder.encode_hash_batch(stacked)

    def _run_group(self, key: tuple, batches: list[np.ndarray]) -> list:
        d, p, _size, code = key
        coder = get_coder(d, p, self.backend, code)
        # Merging pending batches into one [ΣB, d, S] dispatch costs a
        # full extra memcpy (the concatenate).  For the cuda backend it is
        # none: the concatenate lands in its page-locked ``host_buffer``,
        # which the walk copies to the card without staging it again, and
        # merged parts share one launch.  The torch backend's plain
        # versions are vector ops over the whole batch whose SHA loop
        # costs per block, not per row.  numpy loops over parts either
        # way, so for it the copy is pure loss (the JAX package measured
        # the merge halving its CPU ingest) — it runs unmerged.
        merge = getattr(coder.backend, "prefers_merged_batches", False)
        if merge and getattr(coder.backend, "submit_apply", None) is not None:
            # Feed-ahead (the mesh backends): every batch is staged into
            # the backend's bounded window before any is collected, so the
            # devices work on batch k+1 while the host hashes batch k.
            # The group shares its fate as a merged dispatch does, minus
            # the concatenate; hashing overlaps inside
            # encode_hash_batches, so the host_pipeline route is bypassed.
            self.dispatches += len(batches)
            return coder.encode_hash_batches(batches)
        if not merge or len(batches) == 1:
            # Unmerged batches are independent dispatches that happen to
            # share a drain tick: a failure belongs to its own waiter
            # only, and later batches in the group must still encode.
            out = []
            for b in batches:
                self.dispatches += 1
                try:
                    out.append(self._encode(coder, b))
                # re-raised at the owning waiter through _GroupItemError;
                # other batches must proceed
                # lint: broad-except-ok re-raised at the owning waiter
                # through _GroupItemError; other batches must proceed
                except Exception as err:
                    out.append(_GroupItemError(err))
            return out
        self.dispatches += 1
        merged = np.concatenate(batches, axis=0, out=_host_buffer(
            coder, (sum(b.shape[0] for b in batches),) + batches[0].shape[1:]))
        parity, digests = self._encode(coder, merged)
        out = []
        lo = 0
        for batch in batches:
            hi = lo + batch.shape[0]
            out.append((parity[lo:hi], digests[lo:hi]))
            lo = hi
        return out
