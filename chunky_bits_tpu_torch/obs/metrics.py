"""Unified metrics registry: counters, gauges, log-bucket histograms (the
port of the part of ``chunky_bits_tpu/obs/metrics.py`` the file path calls).

One process-wide, thread-safe registry.  Event-recorded series come from
``Profiler.log_request``/``log_read``/``log_write`` through
:func:`record_request`, :func:`record_io` and :func:`record_dropped`;
polled sources (the host pipeline) register weakly with
``register_source``.  Label values come from closed sets, and a family
refuses to grow past :data:`MAX_LABEL_SETS` label sets.  Not ported yet:
the polled-source families, the Prometheus exposition and its parser,
and the fleet merge (with the gateway).
"""

from __future__ import annotations

import bisect
import re
import threading
import weakref
from typing import Optional, Sequence

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: hard per-family ceiling on distinct label sets — the runtime
#: backstop behind lint rule CB107: a family that tries to grow past
#: this is recording an open-ended label (a request path, a client
#: string) and must fail loudly, not leak silently
MAX_LABEL_SETS = 128

#: default histogram layout: fixed log2 buckets from 0.1 ms to ~105 s.
#: Fixed (never adaptive) so merging across workers and scrapes is a
#: plain per-bucket sum.
DEFAULT_TIME_BUCKETS: tuple[float, ...] = tuple(
    1e-4 * (2.0 ** k) for k in range(21))

def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"bad metric name {name!r}")
    return name


class _Cell:
    """One (family, label set) scalar series.  ``inc`` for counters,
    ``set`` for gauges; a lock per cell keeps updates exact under
    concurrent thread + loop recording."""

    __slots__ = ("_lock", "_value")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class _HistCell:
    """One (family, label set) histogram series: per-bucket counts
    (NOT cumulative — exposition cumulates at render), sum, count."""

    __slots__ = ("_lock", "_bounds", "counts", "sum", "count")

    def __init__(self, bounds: tuple[float, ...]) -> None:
        self._lock = threading.Lock()
        self._bounds = bounds
        self.counts = [0] * (len(bounds) + 1)  # last cell = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        idx = bisect.bisect_left(self._bounds, v)
        with self._lock:
            self.counts[idx] += 1
            self.sum += v
            self.count += 1

    def snap(self) -> tuple[list, float, int]:
        with self._lock:
            return list(self.counts), self.sum, self.count


class Family:
    """One named metric family.  ``labels(**kv)`` returns the cell for
    a label set (created on first use, capped at MAX_LABEL_SETS); an
    unlabeled family is its own single cell via ``inc``/``set``/
    ``observe``."""

    def __init__(self, name: str, kind: str, help_: str,
                 labelnames: tuple[str, ...],
                 buckets: Optional[tuple[float, ...]] = None) -> None:
        self.name = _check_name(name)
        self.kind = kind
        self.help = help_
        self.labelnames = labelnames
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln):
                raise ValueError(f"bad label name {ln!r}")
        if kind == HISTOGRAM:
            b = tuple(float(x) for x in (buckets or DEFAULT_TIME_BUCKETS))
            if list(b) != sorted(b) or len(set(b)) != len(b):
                raise ValueError("histogram buckets must be ascending")
            self.buckets: Optional[tuple[float, ...]] = b
        else:
            self.buckets = None
        self._lock = threading.Lock()
        self._cells: dict[tuple[str, ...], object] = {}

    def _new_cell(self) -> object:
        if self.kind == HISTOGRAM:
            assert self.buckets is not None
            return _HistCell(self.buckets)
        return _Cell()

    def labels(self, **kv: str):
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: expected labels {self.labelnames}, "
                f"got {tuple(kv)}")
        key = tuple(str(kv[ln]) for ln in self.labelnames)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                if len(self._cells) >= MAX_LABEL_SETS:
                    raise ValueError(
                        f"{self.name}: more than {MAX_LABEL_SETS} label "
                        "sets — label values must come from a closed "
                        "set (CB107)")
                cell = self._cells[key] = self._new_cell()
        return cell

    def _default(self):
        if self.labelnames:
            raise ValueError(f"{self.name} is labeled; call .labels()")
        return self.labels()

    # unlabeled conveniences
    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def set(self, v: float) -> None:
        self._default().set(v)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def _samples(self) -> list[dict]:
        with self._lock:
            items = sorted(self._cells.items())
        out = []
        for key, cell in items:
            labels = dict(zip(self.labelnames, key))
            if self.kind == HISTOGRAM:
                counts, sum_, count = cell.snap()  # type: ignore[union-attr]
                out.append({"labels": labels, "counts": counts,
                            "sum": sum_, "count": count})
            else:
                out.append({"labels": labels,
                            "value": cell.value})  # type: ignore[union-attr]
        return out


class MetricsRegistry:
    """Thread-safe family container + weakly-registered polled sources;
    ``snapshot()`` is the read path."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, Family] = {}
        self._sources: list[tuple[str, weakref.ref]] = []

    # ---- family factories (get-or-create; shape mismatch raises) ----

    def _family(self, name: str, kind: str, help_: str,
                labelnames: tuple[str, ...],
                buckets: Optional[tuple[float, ...]] = None) -> Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind or fam.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name} re-declared with a different "
                        "shape")
                return fam
            fam = Family(name, kind, help_, labelnames, buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> Family:
        return self._family(name, COUNTER, help_, tuple(labels))

    def gauge(self, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> Family:
        return self._family(name, GAUGE, help_, tuple(labels))

    def histogram(self, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Optional[Sequence[float]] = None) -> Family:
        return self._family(
            name, HISTOGRAM, help_, tuple(labels),
            tuple(buckets) if buckets is not None else None)

    # ---- polled sources ----

    def register_source(self, kind: str, obj: object) -> None:
        """Weakly register a stat source (``kind`` such as "pipeline");
        registration never extends the object's lifetime, so sources
        drop out with their owners."""
        with self._lock:
            self._sources = [(k, r) for k, r in self._sources
                             if r() is not None]
            for k, r in self._sources:
                if k == kind and r() is obj:
                    return
            self._sources.append((kind, weakref.ref(obj)))

    def sources(self, kind: str) -> list:
        """The live sources registered under ``kind``."""
        with self._lock:
            return [r() for k, r in self._sources
                    if k == kind and r() is not None]

    # ---- snapshot ----

    def snapshot(self) -> dict:
        """The direct families as plain JSON-able dicts.  The polled
        sources' families and the Prometheus exposition come with the
        gateway."""
        fams: list[dict] = []
        with self._lock:
            direct = sorted(self._families.items())
        for _name, fam in direct:
            entry: dict = {"name": fam.name, "type": fam.kind,
                           "help": fam.help,
                           "samples": fam._samples()}
            if fam.buckets is not None:
                entry["buckets"] = list(fam.buckets)
            fams.append(entry)
        return {"families": fams}


# ---- the process-global registry ----

_REGISTRY: Optional[MetricsRegistry] = None
_REGISTRY_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry (one per gateway worker process —
    fleet-wide aggregation happens at scrape via the snapshot spool,
    see gateway/workers.py)."""
    global _REGISTRY
    if _REGISTRY is None:
        with _REGISTRY_LOCK:
            if _REGISTRY is None:
                _REGISTRY = MetricsRegistry()
    return _REGISTRY


def swap_registry(registry: Optional[MetricsRegistry]
                  ) -> Optional[MetricsRegistry]:
    """Swap the process registry for ``registry`` (None = a fresh one
    on next :func:`get_registry`); returns the previous registry so
    callers can restore it.  The cluster simulator brackets every
    scenario run with this so two runs of the same seed observe — and
    can compare — exactly the counters that run produced; production
    code never calls it."""
    global _REGISTRY
    with _REGISTRY_LOCK:
        previous = _REGISTRY
        _REGISTRY = registry
    return previous


# ---- event-recorded helpers (Profiler / gateway call these) ----

#: closed label sets for the request/IO series (CB107: anything outside
#: the set clamps to "other" rather than minting a new label value)
_METHODS = frozenset(("GET", "HEAD", "PUT", "POST", "DELETE"))
_SOURCES = frozenset(("cache", "sendfile", "cond", "meta", "store", "-"))


def _status_class(status: int) -> str:
    return f"{status // 100}xx" if 100 <= status <= 599 else "other"


#: cached Family handles for the event-recorded series, built on first
#: use — per-event resolution through the registry would serialize the
#: hot serve path on the one registry lock; the families are fixed, so
#: cache them once (the build race is benign: the registry's
#: get-or-create hands every builder the same Family objects)
_EVENT_FAMILIES: dict[str, Family] = {}


def _event_family(key: str, build) -> Family:
    fam = _EVENT_FAMILIES.get(key)
    if fam is None:
        fam = _EVENT_FAMILIES[key] = build(get_registry())
    return fam


def record_request(method: str, status: int, nbytes: int,
                   duration: float, source: str) -> None:
    """One gateway request into the registry (the event-recorded twin
    of ``Profiler.log_request`` — same numbers, durable series)."""
    method = method if method in _METHODS else "OTHER"
    source = source if source in _SOURCES else "other"
    status_class = _status_class(status)
    _event_family("req_seconds", lambda reg: reg.histogram(
        "cb_request_seconds", "gateway request wall time",
        labels=("method",))).labels(method=method).observe(duration)
    _event_family("req_total", lambda reg: reg.counter(
        "cb_request_total", "gateway requests served",
        labels=("method", "status_class", "source"),
    )).labels(method=method, status_class=status_class,
              source=source).inc()
    _event_family("req_bytes", lambda reg: reg.counter(
        "cb_request_bytes_total", "gateway response body bytes",
        labels=("method",))).labels(method=method).inc(max(nbytes, 0))


def record_io(op: str, ok: bool, nbytes: int, duration: float) -> None:
    """One location I/O completion (``Profiler.log_read``/``log_write``)."""
    op = op if op in ("read", "write") else "other"
    ok_label = "true" if ok else "false"
    _event_family("io_seconds", lambda reg: reg.histogram(
        "cb_io_seconds", "location I/O wall time",
        labels=("op", "ok"))).labels(op=op, ok=ok_label).observe(duration)
    if ok:
        _event_family("io_bytes", lambda reg: reg.counter(
            "cb_io_bytes_total", "location I/O bytes moved",
            labels=("op",))).labels(op=op).inc(max(nbytes, 0))


def record_dropped(kind: str, n: int = 1) -> None:
    """Ring-buffer drop accounting (``Profiler``'s bounded logs)."""
    kind = kind if kind in ("requests", "entries", "location_failures") \
        else "other"
    _event_family("dropped", lambda reg: reg.counter(
        "cb_profiler_dropped_total",
        "profiler log entries dropped by the bounded ring buffers",
        labels=("kind",))).labels(kind=kind).inc(n)
