"""Two-plane request tracing: trace IDs, spans, slowest-N buffer (the
port of ``chunky_bits_tpu/obs/tracing.py``).

A request's :class:`Trace` rides a ``contextvars.ContextVar``, so asyncio
carries it into every task the request spawns; the host pipeline's worker
threads get it by capture-at-submit (``host_pipeline._Job``).  Spans are
flat ``(name, plane, start, duration, outcome)`` records, planes
``gateway``, ``network``, ``host`` and ``compute``.  Untraced, the only
cost anywhere is a ``ContextVar.get`` returning None.  Completed traces at
least ``slow_s`` slow enter the process-wide slowest-N buffer.
"""

from __future__ import annotations

import contextvars
import heapq
import itertools
import os
import threading
from typing import Optional

#: span starts arrive off the clock seam, so the trace's birth stamp that
#: the offsets subtract from comes off the same clock
from chunky_bits_tpu_torch.utils import clock as _clock

#: the active trace for this context; None = tracing off / untraced
#: request.  A ContextVar, not module state: every asyncio task gets
#: its own copy, worker threads read None unless a job carried a
#: captured trace.
_CURRENT: "contextvars.ContextVar[Optional[Trace]]" = \
    contextvars.ContextVar("cb_trace", default=None)

#: bound on spans per trace — a pathological fan-out (thousands of
#: chunk fetches) must not make one trace unbounded; drops are counted
#: on the trace itself
MAX_SPANS = 256

#: traces kept in the slowest-N buffer
BUFFER_CAPACITY = 64

#: accepted ``X-Chunky-Trace`` shape: short, printable, header-safe
_MAX_ID_LEN = 64


class Span:
    __slots__ = ("name", "plane", "start_ms", "duration_ms", "outcome")

    def __init__(self, name: str, plane: str, start_ms: float,
                 duration_ms: float, outcome: str) -> None:
        self.name = name
        self.plane = plane
        self.start_ms = start_ms
        self.duration_ms = duration_ms
        self.outcome = outcome

    def to_obj(self) -> dict:
        return {"name": self.name, "plane": self.plane,
                "start_ms": round(self.start_ms, 3),
                "duration_ms": round(self.duration_ms, 3),
                "outcome": self.outcome}


class Trace:
    """One request's span collection.  ``add`` is thread-safe: loop
    callbacks, hedge tasks AND pipeline worker threads all record onto
    the same trace."""

    __slots__ = ("trace_id", "t0", "spans", "dropped_spans", "_lock")

    def __init__(self, trace_id: str) -> None:
        self.trace_id = trace_id
        self.t0 = _clock.monotonic()
        self.spans: list[Span] = []
        self.dropped_spans = 0
        self._lock = threading.Lock()

    def add(self, name: str, plane: str, start: float, duration: float,
            outcome: str = "ok") -> None:
        """Record one span; ``start`` is a clock-seam ``monotonic()``
        stamp (converted to ms offset from the trace's birth)."""
        span = Span(name, plane, (start - self.t0) * 1000.0,
                    duration * 1000.0, outcome)
        with self._lock:
            if len(self.spans) >= MAX_SPANS:
                self.dropped_spans += 1
                return
            self.spans.append(span)

    def to_obj(self, duration_ms: float, meta: dict) -> dict:
        with self._lock:
            spans = [s.to_obj() for s in self.spans]
            dropped = self.dropped_spans
        planes: dict[str, float] = {}
        for s in spans:
            planes[s["plane"]] = planes.get(s["plane"], 0.0) \
                + s["duration_ms"]
        return {"trace_id": self.trace_id,
                "duration_ms": round(duration_ms, 3),
                "plane_ms": {k: round(v, 3)
                             for k, v in sorted(planes.items())},
                "spans": spans,
                **({"dropped_spans": dropped} if dropped else {}),
                **meta}


class TraceBuffer:
    """Bounded slowest-N keeper: a min-heap on duration, so a new slow
    trace evicts the fastest retained one — the buffer converges on the
    worst tail, exactly the requests worth debugging."""

    def __init__(self, capacity: int = BUFFER_CAPACITY) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._heap: list[tuple[float, int, dict]] = []

    def offer(self, duration_ms: float, record: dict) -> bool:
        with self._lock:
            if len(self._heap) < self.capacity:
                heapq.heappush(self._heap,
                               (duration_ms, next(self._seq), record))
                return True
            if self._heap and duration_ms > self._heap[0][0]:
                heapq.heapreplace(
                    self._heap, (duration_ms, next(self._seq), record))
                return True
            return False

    def snapshot(self) -> list[dict]:
        """Retained traces, slowest first."""
        with self._lock:
            items = sorted(self._heap,
                           key=lambda t: (-t[0], -t[1]))
        return [rec for _d, _s, rec in items]

    def clear(self) -> None:
        with self._lock:
            self._heap = []


#: the process-wide slowest-N buffer /debug/traces serves; per-worker
#: like every other serving-plane store (the fleet view is per-worker
#: by design — a trace is a single worker's story)
_BUFFER = TraceBuffer()


def buffer() -> TraceBuffer:
    return _BUFFER


def mint_id() -> str:
    return os.urandom(8).hex()


def clean_id(raw: Optional[str]) -> str:
    """A usable trace id from a client's ``X-Chunky-Trace`` header —
    minted fresh when absent or unprintable/oversized (header values
    land in JSON debug payloads; garbage must not)."""
    if raw:
        raw = raw.strip()
        if 0 < len(raw) <= _MAX_ID_LEN and raw.isprintable() \
                and '"' not in raw and "\\" not in raw:
            return raw
    return mint_id()


def start(trace_id: str) -> tuple["Trace", "contextvars.Token"]:
    """Open a trace and make it current; pair with :func:`finish`."""
    trace = Trace(trace_id)
    token = _CURRENT.set(trace)
    return trace, token


def finish(trace: "Trace", token: "contextvars.Token", *,
           duration: float, slow_s: float, meta: dict) -> bool:
    """Close out a trace: restore the context and, when the request ran
    at least ``slow_s``, file it in the slowest-N buffer.  Returns
    whether the trace was retained."""
    _CURRENT.reset(token)
    duration_ms = duration * 1000.0
    if duration < slow_s:
        return False
    return _BUFFER.offer(duration_ms,
                         trace.to_obj(duration_ms, dict(meta)))


def current() -> Optional["Trace"]:
    """The context's active trace, or None (tracing off — the one-call
    fast path every instrumented site pays)."""
    return _CURRENT.get()


def record_span(name: str, plane: str, start_t: float, duration: float,
                outcome: str = "ok") -> None:
    """Record a span onto the context's trace; no-op when untraced."""
    trace = _CURRENT.get()
    if trace is not None:
        trace.add(name, plane, start_t, duration, outcome)
