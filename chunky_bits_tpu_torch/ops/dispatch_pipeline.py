"""Bounded FIFO window of in-flight device dispatches.

The port of ``chunky_bits_tpu/ops/dispatch_pipeline.py``, with the same
semantics.  A CUDA launch returns before the card finishes, so a backend
can keep several dispatches in flight: block k+1's host-to-device copy and
the host hash stage run while block k computes and block k-1 drains to the
host (the double buffer, depth 2).  This module keeps that window across
calls, thread-safe.

It is device-agnostic: ``submit`` takes an ``issue`` thunk (the
non-blocking enqueue: pinned host-to-device copies, the launches on each
logical device's stream, the device-to-pinned-host copy and a recorded
``torch.cuda.Event``) and a ``materialize`` function (``event.synchronize()``
plus the host view).  The tests drive it with plain callables.

Ordering is FIFO: materializations happen oldest first, so the window never
holds more than ``depth`` un-materialized dispatches and device memory stays
bounded.  ``cancel()`` drops every pending entry without waiting on the
device; cancelled entries raise :class:`DispatchCancelled` from ``result``.
A failed materialization poisons the window: the younger entries are
cancelled and the error reaches whoever drives the drain.  The port has no
CPU fallback, so a cancelled or failed dispatch ends its call with an error.

Overlap is counted, not assumed: ``stats()`` gives the submits that found
the window busy (``submits_while_busy``), the deepest window
(``max_inflight``) and the host seconds spent in block callbacks while
dispatches were in flight (``host_overlap_s``, fed by the mesh backend).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Optional

#: the double buffer: one dispatch computing, one staging
DEFAULT_DEPTH = 2

_PENDING, _DONE, _FAILED, _CANCELLED = range(4)


class DispatchCancelled(RuntimeError):
    """Raised by ``result`` for entries dropped by ``cancel()`` or by the
    failure of an older entry."""


@dataclass
class DispatchStats:
    """Counter snapshot; the module docstring gives each field."""

    submitted: int = 0
    completed: int = 0
    cancelled: int = 0
    max_inflight: int = 0
    submits_while_busy: int = 0
    host_overlap_s: float = 0.0


class _Entry:
    __slots__ = ("handle", "materialize", "state", "value", "error")

    def __init__(self, materialize: Callable[[object], object]) -> None:
        self.handle: object = None
        self.materialize = materialize
        self.state = _PENDING
        self.value: object = None
        self.error: Optional[BaseException] = None


class DispatchPipeline:
    """Bounded FIFO window of in-flight device dispatches.

    ``depth`` is the number of un-materialized dispatches the window may
    hold after a submit returns: 2 (default) is the double buffer, 1 keeps
    one dispatch in flight, 0 disables overlap (every submit materializes
    before it returns).  ``None`` reads ``tunables.dispatch_depth()``
    (``$CHUNKY_BITS_TORCH_DISPATCH_DEPTH``) at construction.

    One coarse lock: a materialization holds it, so concurrent submitters
    queue behind it, which the FIFO memory bound needs.  Batcher worker
    threads and synchronous callers may share one instance.
    """

    def __init__(self, depth: Optional[int] = None,
                 name: str = "dispatch") -> None:
        if depth is None:
            from chunky_bits_tpu_torch.cluster.tunables import dispatch_depth

            depth = dispatch_depth(default=DEFAULT_DEPTH)
        self.depth = max(0, int(depth))
        self.name = name
        self._lock = threading.Lock()
        self._window: list[_Entry] = []
        self._stats = DispatchStats()

    def submit(self, issue: Callable[[], object],
               materialize: Callable[[object], object]) -> _Entry:
        """Issue a dispatch and admit it to the window, materializing the
        oldest entries first if the window would exceed ``depth``.
        ``issue`` must not block on the device; its return value is the
        handle later passed to ``materialize``."""
        with self._lock:
            st = self._stats
            st.submitted += 1
            if self._window:
                st.submits_while_busy += 1
            entry = _Entry(materialize)
            entry.handle = issue()
            self._window.append(entry)
            st.max_inflight = max(st.max_inflight, len(self._window))
            while len(self._window) > self.depth:
                self._materialize_oldest_locked()
            return entry

    def result(self, entry: _Entry) -> object:
        """Block until ``entry`` is materialized (draining everything older
        first) and return its value; re-raises a stored materialization
        error, and :class:`DispatchCancelled` for dropped entries."""
        with self._lock:
            while entry.state == _PENDING:
                self._materialize_oldest_locked()
            if entry.state == _CANCELLED:
                raise DispatchCancelled(
                    f"{self.name}: dispatch cancelled before completion")
            if entry.state == _FAILED:
                raise entry.error  # type: ignore[misc]
            return entry.value

    def drain(self) -> None:
        """Materialize every pending entry, oldest first; errors propagate
        as from ``result``."""
        with self._lock:
            while self._window:
                self._materialize_oldest_locked()

    def cancel(self) -> None:
        """Drop every pending entry without touching the device.  Never
        blocks."""
        with self._lock:
            self._cancel_rest_locked()

    @property
    def inflight(self) -> int:
        with self._lock:
            return len(self._window)

    def note_host_overlap(self, seconds: float) -> None:
        """Record host time spent in block callbacks while at least one
        dispatch was in flight."""
        with self._lock:
            self._stats.host_overlap_s += seconds

    def stats(self) -> DispatchStats:
        with self._lock:
            return DispatchStats(**vars(self._stats))

    def _cancel_rest_locked(self) -> None:
        for e in self._window:
            e.state = _CANCELLED
            e.handle = None
        self._stats.cancelled += len(self._window)
        self._window.clear()

    def _materialize_oldest_locked(self) -> None:
        e = self._window.pop(0)
        try:
            e.value = e.materialize(e.handle)
            e.state = _DONE
            self._stats.completed += 1
        except BaseException as err:
            # a failed materialization poisons the window: the younger
            # dispatches are cancelled and the error reaches the caller
            e.state = _FAILED
            e.error = err
            self._cancel_rest_locked()
            raise
        finally:
            e.handle = None
