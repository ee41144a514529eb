"""Per-operation I/O telemetry (the port of
``chunky_bits_tpu/file/profiler.py``).

As the reference profiler: reads and writes are logged with result,
location, byte length and start/end times; a reporter drains the log into
a ``ProfileReport`` with average read/write durations and wall/byte
totals.  The logs are count-bounded drop-oldest rings whose drops are
counted (in the report's ``Dropped<...>`` and in the metrics registry),
and every ``log_request``/``log_read``/``log_write`` also records into
the metrics registry and, when a trace is active, onto the trace.  The
report also carries the counters of the host pipelines and the table of
the location-health scoreboards attached to it, and of the read caches
(``file/chunk_cache.py``), the ``Scrub<...>`` stanza of each scrub
daemon attached (``attach_scrub``, cluster/scrub.py), the ``Slo<...>``
stanza of each SLO engine (``attach_slo``, obs/slo.py) and the
``Qos<...>`` stanza of each QoS scheduler (``attach_qos``,
cluster/qos.py).
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Optional

from chunky_bits_tpu_torch.obs import metrics as obs_metrics
from chunky_bits_tpu_torch.obs import tracing as obs_tracing

#: the ``start_time`` values callers pass to log_read/log_write come off
#: the clock seam, so the matching ``end`` read does too
from chunky_bits_tpu_torch.utils import clock as _clock


def percentile(sorted_values: list, q: float) -> float:
    """Linear-interpolated percentile of an ascending-sorted list (the
    numpy 'linear' method, stdlib-only so this module stays
    dependency-free).  THE percentile implementation for the serving
    plane: the gateway access log's stats and bench --config 9's
    client-side latency report both call it, so production p99s and
    bench p99s are computed by the same code."""
    if not sorted_values:
        return 0.0
    if len(sorted_values) == 1:
        return float(sorted_values[0])
    pos = (len(sorted_values) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return float(sorted_values[lo]) * (1 - frac) \
        + float(sorted_values[hi]) * frac


@dataclass
class RequestLog:
    """One gateway request (the access-log record): what was asked,
    what was answered, how long it took and where the bytes came from.
    ``source`` is the serving path: "cache" (all chunks pre-verified in
    the read cache), "sendfile" (zero-copy local whole-chunk stream),
    "cond" (304, zero body bytes), "meta" (HEAD — headers only),
    "store" (fetch+verify+reassemble), or "-" (errors / PUTs)."""

    method: str
    path: str
    status: int
    nbytes: int
    duration: float  # seconds of wall time
    source: str
    #: resolved QoS tenant (cluster/qos.py closed table) or "-" when
    #: the scheduler is off — lets one access log answer per-tenant
    #: p99 questions (tenant_request_stats) without a second log
    tenant: str = "-"


@dataclass
class RequestStats:
    """Aggregate of the drained access log (percentiles via
    :func:`percentile`, shared with bench --config 9)."""

    count: int
    errors: int  # status >= 500
    total_bytes: int
    p50_ms: float
    p99_ms: float
    p999_ms: float

    def to_obj(self) -> dict:
        """Plain-dict form — the gateway's ``/stats`` payload and the
        ``chunky-bits stats`` renderer both read this, so serving
        percentiles stay one implementation away from the source."""
        return {
            "count": self.count,
            "errors": self.errors,
            "total_bytes": self.total_bytes,
            "p50_ms": round(self.p50_ms, 3),
            "p99_ms": round(self.p99_ms, 3),
            "p999_ms": round(self.p999_ms, 3),
        }

    def __str__(self) -> str:
        return (f"Requests<n={self.count} errors={self.errors} "
                f"bytes={self.total_bytes} p50={self.p50_ms:.2f}ms "
                f"p99={self.p99_ms:.2f}ms p999={self.p999_ms:.2f}ms>")


def request_stats(entries: list) -> RequestStats:
    """Roll a list of :class:`RequestLog` into :class:`RequestStats`."""
    lat = sorted(e.duration for e in entries)
    return RequestStats(
        count=len(entries),
        errors=sum(1 for e in entries if e.status >= 500),
        total_bytes=sum(e.nbytes for e in entries),
        p50_ms=percentile(lat, 50) * 1000.0,
        p99_ms=percentile(lat, 99) * 1000.0,
        p999_ms=percentile(lat, 99.9) * 1000.0,
    )


def tenant_request_stats(entries: list) -> dict:
    """Per-tenant :class:`RequestStats` split of the access log —
    the serving-plane isolation question ("whose p99 moved?") answered
    from the SAME records and the SAME :func:`percentile` code as the
    aggregate.  Key count is bounded by the closed tenant table
    (cluster/qos.py) plus "-" for scheduler-off records."""
    by_tenant: dict = {}
    for e in entries:
        by_tenant.setdefault(getattr(e, "tenant", "-"), []).append(e)
    return {tenant: request_stats(rows)
            for tenant, rows in sorted(by_tenant.items())}


@dataclass
class ResultLog:
    kind: str  # "read" | "write"
    ok: bool
    error: Optional[str]
    location: object
    length: int  # bytes moved (read: bytes returned; write: bytes sent)
    start_time: float
    end_time: float

    @property
    def duration(self) -> float:
        return self.end_time - self.start_time


class Profiler:
    """Handed to a LocationContext; log_* is called at the two I/O hooks
    (reference: src/file/location.rs:109-112,240-242).  All in-memory
    logs are drop-oldest rings (see the module docstring) — the recent
    window a reporter actually reads survives, the unbounded tail a
    reporterless gateway would accumulate does not."""

    #: ring bounds: generous next to any reporter's drain cadence (a
    #: bench config-9 run logs a few thousand requests), tiny next to a
    #: week of undrained gateway traffic
    MAX_REQUESTS = 65536
    MAX_ENTRIES = 65536
    MAX_LOCATION_FAILURES = 1024

    def __init__(self, max_requests: Optional[int] = None,
                 max_entries: Optional[int] = None,
                 max_location_failures: Optional[int] = None) -> None:
        self._entries: deque[ResultLog] = deque(
            maxlen=max_entries or self.MAX_ENTRIES)
        self._lock = threading.Lock()
        self._caches: list = []  # read caches whose counters we surface
        self._pipelines: list = []  # host pipelines ditto
        self._healths: list = []  # location-health scoreboards ditto
        self._scrubs: list = []  # scrub daemons ditto
        self._slos: list = []  # SLO engines ditto
        self._qos: list = []  # QoS schedulers ditto
        # per-location failure notes from the read fall-through
        # (fetch_chunk): which location failed / was corrupt and why —
        # the diagnosable trail the anonymous `except LocationError:
        # continue` used to swallow
        self._location_failures: deque[tuple[object, str]] = deque(
            maxlen=max_location_failures or self.MAX_LOCATION_FAILURES)
        # gateway access-log records (one per HTTP request) — the
        # serving-plane analogue of the per-I/O entries above
        self._requests: deque[RequestLog] = deque(
            maxlen=max_requests or self.MAX_REQUESTS)
        # drop-oldest accounting per ring (also counted into the
        # metrics registry as cb_profiler_dropped_total{kind})
        self._dropped = {"requests": 0, "entries": 0,
                         "location_failures": 0}

    def _append(self, ring: deque, kind: str, item: object) -> bool:
        """Ring append with drop accounting; caller holds the lock and
        reports a True return to the registry AFTER releasing it (no
        foreign lock is ever taken under ``self._lock``)."""
        dropped = ring.maxlen is not None and len(ring) == ring.maxlen
        if dropped:
            self._dropped[kind] += 1
        ring.append(item)
        return dropped

    def drop_counts(self) -> dict:
        """Per-ring drop-oldest counts since construction."""
        with self._lock:
            return dict(self._dropped)

    def attach_cache(self, cache) -> None:
        """Register a chunk cache so its hit/miss/eviction/singleflight
        counters ride along in the report: cache hits never reach the
        read hooks, so a fully hot read would otherwise profile as no
        I/O at all."""
        with self._lock:
            if all(c is not cache for c in self._caches):
                self._caches.append(cache)

    def cache_stats(self) -> list:
        """Snapshot of each attached cache's counters (CacheStats)."""
        with self._lock:
            return [c.stats() for c in self._caches]

    def attach_pipeline(self, pipeline) -> None:
        """Register a host pipeline (parallel/host_pipeline.py) so its
        per-stage busy/idle/bytes counters ride along in the report —
        hashing and encode run on its workers, not at the I/O hooks, so
        saturation would otherwise be invisible here."""
        with self._lock:
            if all(p is not pipeline for p in self._pipelines):
                self._pipelines.append(pipeline)

    def pipeline_stats(self) -> list:
        """Snapshot of each attached pipeline's counters
        (PipelineStats)."""
        with self._lock:
            return [p.stats() for p in self._pipelines]

    def attach_health(self, health) -> None:
        """Register a location-health scoreboard (cluster/health.py) so
        its per-location table (EWMA latency, error rate, breaker state,
        hedges fired/won/cancelled) rides along in the report."""
        with self._lock:
            if all(h is not health for h in self._healths):
                self._healths.append(health)

    def health_stats(self) -> list:
        """Snapshot of each attached scoreboard (HealthStats)."""
        with self._lock:
            return [h.stats() for h in self._healths]

    def attach_scrub(self, scrub) -> None:
        """Register a scrub daemon so its counters ride along in the
        report (scrub I/O happens outside any one operation's hooks)."""
        with self._lock:
            if all(s is not scrub for s in self._scrubs):
                self._scrubs.append(scrub)

    def scrub_stats(self) -> list:
        """Snapshot of each attached scrub daemon."""
        with self._lock:
            return [s.stats() for s in self._scrubs]

    def attach_slo(self, engine) -> None:
        """Register an SLO engine (obs/slo.py) so its firing and pending
        alerts ride along in the report's ``Slo<...>`` stanza: the report
        and ``GET /alerts`` tell one story."""
        with self._lock:
            if all(e is not engine for e in self._slos):
                self._slos.append(engine)

    def slo_stats(self) -> list:
        """Snapshot of each attached SLO engine (SloStats)."""
        with self._lock:
            return [e.stats() for e in self._slos]

    def attach_qos(self, scheduler) -> None:
        """Register a QoS scheduler (cluster/qos.py) so its per-tenant
        admission, shed and queue counters ride along in the report's
        ``Qos<...>`` stanza, the snapshot ``/stats`` and the ``cb_qos_*``
        families read too."""
        with self._lock:
            if all(q is not scheduler for q in self._qos):
                self._qos.append(scheduler)

    def qos_stats(self) -> list:
        """Snapshot of each attached QoS scheduler (QosStats)."""
        with self._lock:
            return [q.stats() for q in self._qos]

    def log_location_failure(self, location, error: str) -> None:
        """A per-location read failure (unreadable or hash-mismatched)
        recorded by the chunk fall-through — the read completed via
        another location or reconstruction, but a degraded cluster must
        stay diagnosable."""
        with self._lock:
            dropped = self._append(self._location_failures,
                                   "location_failures",
                                   (location, error))
        if dropped:
            obs_metrics.record_dropped("location_failures")

    def drain_location_failures(self) -> list[tuple[object, str]]:
        with self._lock:
            out = list(self._location_failures)
            self._location_failures.clear()
        return out

    def log_request(self, method: str, path: str, status: int,
                    nbytes: int, duration: float, source: str,
                    tenant: str = "-") -> None:
        """One gateway request completed (gateway/http.py's access-log
        middleware): the same counters production logs print feed the
        report's :class:`RequestStats`, so serving percentiles come
        from one code path whether read off a log line or a bench
        run.  ``tenant`` is the resolved QoS tenant ("-" = scheduler
        off) — it stays OUT of the registry's request families (the
        per-tenant series are the scheduler's own ``cb_qos_*``) and
        IN the access log for :func:`tenant_request_stats`."""
        entry = RequestLog(method, path, status, nbytes, duration,
                           source, tenant)
        with self._lock:
            dropped = self._append(self._requests, "requests", entry)
        if dropped:
            obs_metrics.record_dropped("requests")
        obs_metrics.record_request(method, status, nbytes, duration,
                                   source)

    def drain_requests(self) -> list[RequestLog]:
        with self._lock:
            out = list(self._requests)
            self._requests.clear()
        return out

    def peek_requests(self) -> list[RequestLog]:
        """Non-draining snapshot of the request ring — the gateway's
        ``/stats`` summary must not steal entries from a reporter."""
        with self._lock:
            return list(self._requests)

    def log_read(self, ok: bool, error: Optional[str], location,
                 length: int, start_time: float) -> None:
        end = _clock.monotonic()
        entry = ResultLog("read", ok, error, location, length,
                          start_time, end)
        with self._lock:
            dropped = self._append(self._entries, "entries", entry)
        if dropped:
            obs_metrics.record_dropped("entries")
        obs_metrics.record_io("read", ok, length, end - start_time)
        # no io.read span: the read path's network time is already
        # attributed by the enclosing chunk_fetch span
        # (file/file_part.py) — a second span here would double-count
        # plane_ms["network"] in /debug/traces

    def log_write(self, ok: bool, error: Optional[str], location,
                  length: int, start_time: float) -> None:
        end = _clock.monotonic()
        entry = ResultLog("write", ok, error, location, length,
                          start_time, end)
        with self._lock:
            dropped = self._append(self._entries, "entries", entry)
        if dropped:
            obs_metrics.record_dropped("entries")
        obs_metrics.record_io("write", ok, length, end - start_time)
        obs_tracing.record_span("io.write", "network", start_time,
                                end - start_time,
                                "ok" if ok else "error")

    def drain(self) -> list[ResultLog]:
        with self._lock:
            out = list(self._entries)
            self._entries.clear()
        return out


class ProfileReport:
    def __init__(self, entries: list[ResultLog], cache_stats: list = (),
                 pipeline_stats: list = (), health_stats: list = (),
                 location_failures: list = (), requests: list = (),
                 scrub_stats: list = (), slo_stats: list = (),
                 dropped: Optional[dict] = None, qos_stats: list = ()):
        self.entries = entries
        self.cache_stats = list(cache_stats)
        self.pipeline_stats = list(pipeline_stats)
        self.health_stats = list(health_stats)
        self.scrub_stats = list(scrub_stats)
        self.slo_stats = list(slo_stats)
        self.qos_stats = list(qos_stats)
        self.location_failures = list(location_failures)
        self.requests = list(requests)
        self.dropped = dict(dropped or {})

    def _avg(self, kind: str) -> Optional[float]:
        durations = [e.duration for e in self.entries if e.kind == kind]
        if not durations:
            return None
        return sum(durations) / len(durations)

    def average_read_duration(self) -> Optional[float]:
        return self._avg("read")

    def average_write_duration(self) -> Optional[float]:
        return self._avg("write")

    def total_time(self) -> Optional[float]:
        if not self.entries:
            return None
        return self.entries[-1].end_time - self.entries[0].start_time

    def total_bytes(self) -> int:
        return sum(e.length for e in self.entries if e.ok)

    def __str__(self) -> str:
        def ms(v: Optional[float]) -> str:
            return "None" if v is None else str(int(v * 1000))

        base = (
            f"ReadAvg<{ms(self.average_read_duration())}ms> "
            f"WriteAvg<{ms(self.average_write_duration())}ms> "
            f"Total<{ms(self.total_time())}ms> Total<{self.total_bytes()}B>"
        )
        for stats in self.cache_stats:
            base += f" {stats}"
        for stats in self.pipeline_stats:
            base += f" {stats}"
        for stats in self.health_stats:
            base += f" {stats}"
        for stats in self.scrub_stats:
            base += f" {stats}"
        for stats in self.slo_stats:
            base += f" {stats}"
        for stats in self.qos_stats:
            base += f" {stats}"
        if self.requests:
            base += f" {request_stats(self.requests)}"
        if self.location_failures:
            shown = "; ".join(f"{loc}: {err}"
                              for loc, err in self.location_failures[:8])
            extra = len(self.location_failures) - 8
            if extra > 0:
                shown += f"; +{extra} more"
            base += f" ReadFailures<{shown}>"
        drops = {k: v for k, v in self.dropped.items() if v}
        if drops:
            inner = " ".join(f"{k}={v}" for k, v in sorted(drops.items()))
            base += f" Dropped<{inner}>"
        return base


class ProfileReporter:
    """Pairs with a Profiler (reference: new_profiler(), profiler.rs:33-65)."""

    def __init__(self, profiler: Profiler):
        self._profiler = profiler

    def profile(self) -> ProfileReport:
        return ProfileReport(self._profiler.drain(),
                             self._profiler.cache_stats(),
                             self._profiler.pipeline_stats(),
                             self._profiler.health_stats(),
                             self._profiler.drain_location_failures(),
                             self._profiler.drain_requests(),
                             self._profiler.scrub_stats(),
                             self._profiler.slo_stats(),
                             self._profiler.drop_counts(),
                             self._profiler.qos_stats())


def new_profiler() -> tuple[Profiler, ProfileReporter]:
    p = Profiler()
    return p, ProfileReporter(p)
