"""Shared multi-core host compute pipeline: ingest hashing and encode (the
port of ``chunky_bits_tpu/parallel/host_pipeline.py``).

A bounded, stage-aware executor that runs host compute on ``min(N, nproc)``
daemon worker threads, where N comes from an explicit
``HostPipeline(threads=N)`` or ``$CHUNKY_BITS_TORCH_HOST_THREADS`` (read at
first use).  Every job writes only its own slice of a preallocated output,
so results assemble positionally with no reorder step.

Invariants by construction:

* workers are daemon threads and never needed for interpreter exit;
* every queue put/get is bounded: workers poll ``get`` with a timeout,
  ``submit`` never blocks (a full queue runs the job on the caller), and
  the async path's blocking put is off-loop and timeout-polled;
* a job's result or error is recorded in a ``finally`` before its waiters
  wake, so no waiter hangs on a finished job.

Slicing units (zero-copy): stripes for the host codec's fused
encode+hash (``NativeBackend.encode_and_hash_into``, ``nthreads=1`` a
slice, so a ``native:N`` cap keeps meaning total host threads), and shard
rows for SHA-256 otherwise.

With ``$CHUNKY_BITS_TORCH_SANITIZE`` set, a pipeline installs the runtime
concurrency sanitizer (``analysis/sanitizer.py``) at construction, and
every job reports to its handoff checker: ``run`` records each submit and
checks that the completion resolves on the submitting loop's thread, and
a blocking wait issued from a loop thread (``_Job.join`` on an unfinished
job, or ``encode_hash_sync``'s whole-batch device route) is a violation.
The hooks reach the sanitizer only through ``sys.modules``: with the flag
unset they cost one dict lookup and import nothing.
"""

from __future__ import annotations

import asyncio
import os
import queue
import sys
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from chunky_bits_tpu_torch.errors import ErasureError
from chunky_bits_tpu_torch.obs import tracing as obs_tracing

#: worker queue poll: the bound on every blocking get/put
_POLL_SECONDS = 0.5


def _sanitizer():
    """The active runtime concurrency sanitizer, or None.  Reached only
    through ``sys.modules`` so the sanitize-off path costs one dict lookup
    and never imports the instrumentation."""
    mod = sys.modules.get("chunky_bits_tpu_torch.analysis.sanitizer")
    return mod.active() if mod is not None else None


class _Job:
    """One unit of host compute: a zero-arg callable tagged with a stage
    name and a byte count for the per-stage counters.  A minimal future:
    the running thread records result-or-exception and fires callbacks
    exactly once."""

    __slots__ = ("stage", "fn", "nbytes", "result", "error",
                 "_event", "_callbacks", "_lock", "_started",
                 "trace", "submitted_at")

    def __init__(self, stage: str, fn: Callable[[], Any],
                 nbytes: int = 0) -> None:
        self.stage = stage
        self.fn = fn
        self.nbytes = nbytes
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self._event = threading.Event()
        self._callbacks: list[Callable[["_Job"], None]] = []
        self._lock = threading.Lock()
        self._started = False
        # capture-at-submit: the submitting thread's trace rides the job
        # across the thread boundary
        self.trace = obs_tracing.current()
        self.submitted_at = time.monotonic() if self.trace is not None \
            else 0.0

    def _claim(self) -> bool:
        """Claim the right to run this job; exactly one claimant (a
        worker, a close() drain or a caller-side rescue) runs ``fn``."""
        with self._lock:
            if self._started:
                return False
            self._started = True
            return True

    def add_done_callback(self, cb: Callable[["_Job"], None]) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def _finish(self) -> None:
        with self._lock:
            self._event.set()
            cbs, self._callbacks = self._callbacks, []
        for cb in cbs:
            cb(self)

    def join(self) -> None:
        """Wait for completion without raising (polled, so the wait stays
        interruptible at interpreter shutdown)."""
        if not self._event.is_set():
            # a blocking wait issued FROM a loop thread stalls every
            # request on that loop; the sanitizer records it (a finished
            # job, such as an inline one, never waits and is exempt)
            san = _sanitizer()
            if san is not None:
                san.handoff.check_sync_wait("_Job.join()")
        while not self._event.wait(_POLL_SECONDS):
            pass

    def wait(self) -> Any:
        """Result, re-raising the job's error verbatim."""
        self.join()
        if self.error is not None:
            raise self.error
        return self.result


def join_jobs(jobs: list[_Job]) -> None:
    """Wait for every job, then raise the first recorded error (after all
    finished, so shared output buffers are quiescent)."""
    for job in jobs:
        job.join()
    for job in jobs:
        if job.error is not None:
            raise job.error


def _ranges(n: int, k: int) -> list[tuple[int, int]]:
    """min(k, n) contiguous near-even [lo, hi) slices covering range(n)."""
    k = max(1, min(k, n))
    base, rem = divmod(n, k)
    out = []
    lo = 0
    for i in range(k):
        hi = lo + base + (1 if i < rem else 0)
        out.append((lo, hi))
        lo = hi
    return out


@dataclass(frozen=True)
class PipelineStageStats:
    stage: str
    jobs: int
    busy_s: float
    nbytes: int

    def to_obj(self) -> dict:
        return {"stage": self.stage, "jobs": self.jobs,
                "busy_s": round(self.busy_s, 6), "nbytes": self.nbytes}

    def __str__(self) -> str:
        return f"{self.stage}: {self.jobs}j/{self.busy_s:.3f}s/{self.nbytes}B"


@dataclass(frozen=True)
class PipelineStats:
    """Cumulative counters: per-stage busy seconds and bytes against the
    workers' idle seconds."""

    threads: int
    idle_s: float
    stages: tuple[PipelineStageStats, ...]

    def to_obj(self) -> dict:
        return {"threads": self.threads,
                "idle_s": round(self.idle_s, 6),
                "stages": [s.to_obj() for s in self.stages]}

    def __str__(self) -> str:
        inner = " | ".join(str(s) for s in self.stages)
        if inner:
            inner += " | "
        return f"Pipeline<{self.threads}w {inner}idle {self.idle_s:.3f}s>"


class HostPipeline:
    """Bounded stage-aware scheduler for host compute.  ``threads=None``
    resolves ``tunables.host_threads`` and clamps to ``min(N, nproc)``; an
    explicit count is honored exactly.

    The sync entry points (``submit``/``encode_hash_sync``) are for worker
    or ordinary threads; the async ones (``run``/``encode_hash``) never
    block the event loop."""

    #: async jobs at or below this byte count run inline on the awaiting
    #: coroutine: the thread hop costs more than the compute, and lockstep
    #: completion keeps the arrivals the batchers coalesce on together.
    #: 0-byte (unknown-size) jobs always go to a worker.
    INLINE_NBYTES = 128 << 10

    def __init__(self, threads: Optional[int] = None, *,
                 queue_depth: Optional[int] = None,
                 name: str = "cb-host") -> None:
        nproc = os.cpu_count() or 1
        if threads is None:
            from chunky_bits_tpu_torch.cluster.tunables import host_threads

            n = min(host_threads(default=0) or nproc, nproc)
        else:
            n = int(threads)
        self.threads = max(1, n)
        self._q: "queue.Queue[_Job]" = queue.Queue(
            maxsize=queue_depth or max(128, 8 * self.threads))
        self._shutdown = threading.Event()
        self._lock = threading.Lock()
        self._stages: dict[str, list] = {}  # stage -> [jobs, busy_s, bytes]
        self._idle_s = 0.0
        self._local = threading.local()
        # self-activate the runtime sanitizer when the flag asks for it
        # (read at first use, like host_threads); when off, nothing is
        # imported and no per-job instrumentation exists
        from chunky_bits_tpu_torch.cluster.tunables import sanitize_enabled

        if sanitize_enabled():
            from chunky_bits_tpu_torch.analysis.sanitizer import get_monitor

            get_monitor()
        # weakly self-register with the process metrics registry
        from chunky_bits_tpu_torch.obs.metrics import get_registry

        get_registry().register_source("pipeline", self)
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"{name}-{i}")
            for i in range(self.threads)
        ]
        for w in self._workers:
            w.start()

    # ---- worker plumbing ----

    def _worker(self) -> None:
        self._local.on_worker = True
        while not self._shutdown.is_set():
            t0 = time.perf_counter()
            try:
                job = self._q.get(timeout=_POLL_SECONDS)
            except queue.Empty:
                continue
            dt = time.perf_counter() - t0
            with self._lock:
                self._idle_s += dt
            self._run_job(job)

    def _run_job(self, job: _Job) -> None:
        if not job._claim():
            return  # a racing claimant already ran it
        # lint: clock-escape-ok real worker-thread stage profiling;
        # real thread work has zero virtual width under sim
        t0 = time.perf_counter()
        # lint: clock-escape-ok trace spans timestamp real host work
        t0_mono = time.monotonic() if job.trace is not None else 0.0
        try:
            job.result = job.fn()
        # delivered verbatim to the waiter via job.error
        # lint: broad-except-ok delivered verbatim to the waiter via
        # job.error (wait/join_jobs re-raise); nothing is swallowed
        except BaseException as err:
            job.error = err
        finally:
            # lint: clock-escape-ok real worker-thread stage profiling
            dt = time.perf_counter() - t0
            with self._lock:
                st = self._stages.setdefault(job.stage, [0, 0.0, 0])
                st[0] += 1
                st[1] += dt
                st[2] += job.nbytes
            if job.trace is not None:
                # how long the job waited in the queue, and how long it ran
                job.trace.add(f"queue.{job.stage}", "host",
                              job.submitted_at,
                              max(t0_mono - job.submitted_at, 0.0))
                job.trace.add(f"pipeline.{job.stage}", "host", t0_mono,
                              dt, "ok" if job.error is None
                              else "error")
            job._finish()

    def _offer(self, job: _Job) -> None:
        """Queue a job without ever blocking: a full queue, shutdown, or a
        call from one of our own workers runs it inline on the caller."""
        if getattr(self._local, "on_worker", False) \
                or self._shutdown.is_set():
            self._run_job(job)
            return
        try:
            self._q.put_nowait(job)
        except queue.Full:
            self._run_job(job)
            return
        if self._shutdown.is_set():
            # closed between the check and the put: rescue inline
            self._run_job(job)

    def _put_blocking(self, job: _Job) -> None:
        """Off-loop blocking put, timeout-polled against shutdown."""
        while not self._shutdown.is_set():
            try:
                self._q.put(job, timeout=_POLL_SECONDS)
            except queue.Full:
                continue
            if self._shutdown.is_set():
                self._run_job(job)
            return
        self._run_job(job)

    # ---- core API ----

    def submit(self, stage: str, fn: Callable[[], Any], *,
               nbytes: int = 0) -> _Job:
        """Queue one job (sync callers); returns its handle for
        ``wait()``.  Never blocks."""
        job = _Job(stage, fn, nbytes)
        self._offer(job)
        return job

    async def run(self, stage: str, fn: Callable[[], Any], *,
                  nbytes: int = 0) -> Any:
        """Run one sync job on the pipeline and await its result: the
        ``asyncio.to_thread`` analogue with stage accounting on the
        bounded worker set.  Small known-size jobs run inline."""
        job = _Job(stage, fn, nbytes)
        san = _sanitizer()
        token = san.handoff.submit_token() if san is not None else None
        if 0 < nbytes <= self.INLINE_NBYTES:
            self._run_job(job)
            if token is not None:
                # completes on the submitting side by construction; it is
                # recorded and checked so a sanitized run counts every job
                san.handoff.check_resolve(token)
            return job.wait()
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()

        def bridge(j: _Job) -> None:
            def resolve() -> None:
                if token is not None and san is not None:
                    # the handoff contract: this completion must be
                    # delivered on the submitting loop's thread
                    san.handoff.check_resolve(token)
                if fut.cancelled():
                    return
                if j.error is not None:
                    fut.set_exception(j.error)
                else:
                    fut.set_result(j.result)

            try:
                loop.call_soon_threadsafe(resolve)
            except RuntimeError:
                pass  # loop already closed; no waiter left to wake

        job.add_done_callback(bridge)
        if self._shutdown.is_set():
            # closed pipeline: a plain thread hop, never a hang
            await asyncio.to_thread(self._run_job, job)
        else:
            try:
                self._q.put_nowait(job)
            except queue.Full:
                await asyncio.to_thread(self._put_blocking, job)
            else:
                if self._shutdown.is_set():
                    await asyncio.to_thread(self._run_job, job)
        # resolved in every outcome: the runner records result-or-error in
        # a finally and fires the bridge
        # lint: unbounded-await-ok resolved in every outcome: the runner
        # records result-or-error in a finally and fires the bridge
        # callback; jobs are pure host compute on daemon workers
        return await fut

    def _scatter(self, jobs: list[_Job]) -> None:
        """Fan jobs out to the workers and wait; raises the first job
        error once every job finished."""
        for job in jobs:
            self._offer(job)
        join_jobs(jobs)

    # ---- the ingest compute: encode + hash ----

    def hash_rows_jobs(self, rows: np.ndarray, out: np.ndarray, *,
                       stage: str = "hash") -> list[_Job]:
        """Queue sliced row-hash jobs, ``out[..., 32] = sha256`` of each
        ``rows[..., S]`` row, without waiting (callers overlap them with a
        device dispatch, then ``join_jobs``).  Both arrays must be
        C-contiguous."""
        if not (rows.flags.c_contiguous and out.flags.c_contiguous):
            raise ErasureError("hash_rows_jobs needs contiguous arrays")
        # rows of length 0 hash too: no -1 in the shape, it is ambiguous
        # for an empty array
        n = int(np.prod(rows.shape[:-1]))
        flat = rows.reshape(n, rows.shape[-1])
        oflat = out.reshape(n, 32)
        hasher = _row_hasher()
        jobs = []
        for lo, hi in _ranges(flat.shape[0], self.threads):
            jobs.append(_Job(
                stage,
                lambda lo=lo, hi=hi: hasher(flat[lo:hi], oflat[lo:hi], 1),
                (hi - lo) * flat.shape[-1]))
        for job in jobs:
            self._offer(job)
        return jobs

    def encode_hash_sync(self, coder: Any, stacked: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        """``ErasureCoder.encode_hash_batch`` over the workers:
        ``(parity[B, p, S], digests[B, d+p, 32])`` for ``stacked[B, d,
        S]``, byte-identical to the direct call.  Blocking: call it from a
        worker thread (``encode_hash`` is the loop-safe wrapper).

        A device backend with its own ``encode_and_hash`` (``cuda``,
        ``torch``) gets the whole batch in one call on the calling thread,
        so a staged batch reaches the card as the walk's blocks, not as
        many small dispatches.  The host codec (``native``, which has
        ``encode_and_hash_into``) with B >= 2 is sliced by stripes: each
        worker runs the fused pass over its range of stripes with
        ``nthreads=1``, straight into its rows of the shared outputs.
        Otherwise (``numpy``, one stripe, a code with its own encode math)
        the data rows hash on the workers beside the encode, and the
        parity rows after it.  A ``native:N`` backend caps the workers
        used at N: the knob means total host threads."""
        stacked = np.ascontiguousarray(stacked, dtype=np.uint8)
        if stacked.ndim != 3 or stacked.shape[1] != coder.data:
            raise ErasureError(
                f"expected stacked [B, {coder.data}, S], "
                f"got {stacked.shape}")
        b, d, s = stacked.shape
        p = coder.parity
        into = getattr(coder.backend, "encode_and_hash_into", None)
        if b == 0 or s == 0 or (into is None and getattr(
                coder.backend, "encode_and_hash", None) is not None):
            san = _sanitizer()
            if san is not None:
                # the whole batch runs on the calling thread: from a loop
                # thread that blocks the loop for the device's round trip
                san.handoff.check_sync_wait("encode_hash_sync()")
            job = _Job("encode", lambda: coder.encode_hash_batch(stacked),
                       b * d * s)
            self._run_job(job)
            return job.wait()
        cap = getattr(coder.backend, "nthreads", 0) or 0
        k = self.threads if cap <= 0 else min(self.threads, cap)

        if into is not None and coder.supports_fused_ingest and (
                b >= 2 or k == 1):
            parity = np.empty((b, p, s), dtype=np.uint8)
            digests = np.empty((b, d + p, 32), dtype=np.uint8)
            self._scatter([
                _Job("encode",
                     lambda lo=lo, hi=hi: into(
                         coder.parity_rows, stacked[lo:hi],
                         parity[lo:hi], digests[lo:hi], 1),
                     (hi - lo) * d * s)
                for lo, hi in _ranges(b, k)])
            return parity, digests

        hasher = _row_hasher()
        flat = stacked.reshape(b * d, s)
        ddig = np.empty((b * d, 32), dtype=np.uint8)
        hash_jobs = [
            _Job("hash",
                 lambda lo=lo, hi=hi: hasher(flat[lo:hi], ddig[lo:hi], 1),
                 (hi - lo) * s)
            for lo, hi in _ranges(b * d, k)
        ]
        enc = _Job("encode", lambda: coder.encode_batch(stacked), b * d * s)
        self._scatter(hash_jobs + [enc])
        parity = np.ascontiguousarray(enc.result)
        data_digests = ddig.reshape(b, d, 32)
        if p == 0:
            return parity, data_digests
        pdig = np.empty((b * p, 32), dtype=np.uint8)
        pflat = parity.reshape(b * p, s)
        pjobs = [
            _Job("hash",
                 lambda lo=lo, hi=hi: hasher(pflat[lo:hi], pdig[lo:hi], 1),
                 (hi - lo) * s)
            for lo, hi in _ranges(b * p, k)
        ]
        self._scatter(pjobs)
        return parity, np.concatenate(
            [data_digests, pdig.reshape(b, p, 32)], axis=1)

    async def encode_hash(self, coder: Any, stacked: np.ndarray
                          ) -> tuple[np.ndarray, np.ndarray]:
        """Loop-safe ``encode_hash_sync``."""
        return await asyncio.to_thread(self.encode_hash_sync, coder,
                                       stacked)

    # ---- observability / lifecycle ----

    def stats(self) -> PipelineStats:
        with self._lock:
            stages = tuple(
                PipelineStageStats(stage, st[0], st[1], st[2])
                for stage, st in sorted(self._stages.items()))
            return PipelineStats(self.threads, self._idle_s, stages)

    def close(self, timeout: float = 5.0) -> None:
        """Stop the workers; already-queued jobs are drained inline so no
        waiter is abandoned."""
        self._shutdown.set()
        # lint: clock-escape-ok join deadline bounds REAL threads at
        # shutdown — virtual time cannot advance a parked OS thread
        deadline = time.monotonic() + timeout
        for w in self._workers:
            # lint: clock-escape-ok same real join deadline
            w.join(max(0.0, deadline - time.monotonic()))
        while True:
            try:
                job = self._q.get_nowait()
            except queue.Empty:
                break
            self._run_job(job)


def _row_hasher() -> Callable[[np.ndarray, np.ndarray, int], None]:
    from chunky_bits_tpu_torch.ops.backend import row_hasher

    return row_hasher()


_SHARED: Optional[HostPipeline] = None
_SHARED_LOCK = threading.Lock()


def get_host_pipeline() -> HostPipeline:
    """The process-shared pipeline, built on first use with
    ``min($CHUNKY_BITS_TORCH_HOST_THREADS or nproc, nproc)`` workers."""
    global _SHARED
    if _SHARED is None:
        with _SHARED_LOCK:
            if _SHARED is None:
                _SHARED = HostPipeline()
    return _SHARED
