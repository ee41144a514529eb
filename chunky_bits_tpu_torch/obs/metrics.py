"""Unified metrics registry: counters, gauges, log-bucket histograms (the
port of ``chunky_bits_tpu/obs/metrics.py``).

One process-wide, thread-safe registry is the sink behind every stat
source:

* **event-recorded series**: ``Profiler.log_request``/``log_read``/
  ``log_write`` feed latency histograms and byte counters through
  :func:`record_request`, :func:`record_io` and :func:`record_dropped`;
  the gateway's admission and shed counters increment registry counters
  directly;
* **polled sources**: ``ChunkCache``, ``HostPipeline``,
  ``HealthScoreboard``, the scrub daemon, the repair planner, the
  scheduled-XOR cache and the QoS scheduler register weakly at
  construction and are read at scrape time off their ``stats()``
  (:func:`_source_families`).

Exposition is Prometheus text (:func:`render_exposition`), checked by
the strict line-grammar parser :func:`parse_exposition`.
:func:`merge_snapshots` is the multi-worker gateway's fleet view:
counters and histograms sum across workers, gauges gain a ``worker``
label (gateway/workers.py spools per-worker JSON snapshots, and any
worker's ``/metrics`` merges them).

Label values come from closed sets (HTTP method, status class, serving
source, pipeline stage, configured node key), never from request paths
or other client strings; a family refuses to grow past
:data:`MAX_LABEL_SETS` label sets.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import re
import threading
import weakref
from typing import Iterable, Optional, Sequence

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



class ExpositionError(ValueError):
    """A /metrics payload violated the exposition line grammar."""


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
        """Weakly register a stat source (``kind`` one of "cache",
        "pipeline", "health", "repair", "scrub", "xor_schedule", "qos"); its
        ``stats()`` (``info()`` for the xor-schedule cache) is folded into
        every snapshot while the object lives;
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
        """The direct families plus the polled sources' families, as
        plain JSON-able dicts: the gateway's ``/stats`` payload, the
        fleet spool's format and :func:`render_exposition`'s input."""
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
        fams.extend(_source_families(self))
        fams.sort(key=lambda f: f["name"])
        return {"families": fams}

    def render(self) -> str:
        return render_exposition(self.snapshot())


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
# lint: loop-shared-ok deliberate process-wide cache of process-wide
# Family singletons; Family cells are themselves lock-guarded
_EVENT_FAMILIES: dict[str, Family] = {}


def _event_family(key: str, build) -> Family:
    fam = _EVENT_FAMILIES.get(key)
    if fam is None:
        fam = _EVENT_FAMILIES[key] = build(get_registry())
    return fam


def record_build_info(version: str, backend: str, flags: dict,
                      registry: Optional[MetricsRegistry] = None
                      ) -> None:
    """Publish the ``cb_build_info`` static-info gauge: value 1, with
    the process's version, erasure backend, and active tunable flags as
    labels.  The point is the FLEET view: gauges gain a ``worker``
    label in the spool merge, so one ``/metrics`` scrape of a
    supervisor fleet shows exactly which worker runs which version and
    configuration — a mixed-version or mixed-flag rollout is visible at
    a glance instead of invisible until it bites.

    Labels come from closed sets by construction: ``version`` is the baked
    package version, ``backend`` comes from cluster config, and every
    flag value is a closed token ("on"/"off", a KNOWN_CODES member) —
    the caller clamps, like ``record_request`` does."""
    labels = {"version": str(version), "backend": str(backend or "auto")}
    for key in sorted(flags):
        labels[str(key)] = str(flags[key])
    (registry or get_registry()).gauge(
        "cb_build_info",
        "build/configuration identity (value is always 1)",
        labels=tuple(labels),
    ).labels(**labels).set(1)


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


# ---- polled-source adapters ----


def _sum_rows(rows: Iterable[dict], keys: Sequence[str]) -> dict:
    out = {k: 0.0 for k in keys}
    for row in rows:
        for k in keys:
            out[k] += float(row.get(k, 0) or 0)
    return out


def _fam(name: str, kind: str, help_: str, samples: list[dict]) -> dict:
    return {"name": name, "type": kind, "help": help_,
            "samples": samples}


def _scalar(value: float, **labels: str) -> dict:
    return {"labels": labels, "value": float(value)}


def _source_families(reg: MetricsRegistry) -> list[dict]:
    """Fold the live registered sources into snapshot families.
    Multiple same-kind sources in one process (per-loop caches, a
    sweep's pinned pipelines) sum — these are process totals, the
    per-instance view stays in the Profiler stanzas."""
    fams: list[dict] = []

    caches = [c.stats().to_obj() for c in reg.sources("cache")]
    if caches:
        s = _sum_rows(caches, ("hits", "misses", "coalesced", "inserts",
                               "evictions", "rejects", "size_bytes",
                               "capacity_bytes", "entries"))
        for key in ("hits", "misses", "coalesced", "inserts",
                    "evictions", "rejects"):
            fams.append(_fam(f"cb_cache_{key}_total", COUNTER,
                             f"chunk cache {key}", [_scalar(s[key])]))
        for key in ("size_bytes", "capacity_bytes", "entries"):
            fams.append(_fam(f"cb_cache_{key}", GAUGE,
                             f"chunk cache {key}", [_scalar(s[key])]))

    pipes = [p.stats().to_obj() for p in reg.sources("pipeline")]
    if pipes:
        fams.append(_fam("cb_pipeline_threads", GAUGE,
                         "host pipeline worker threads",
                         [_scalar(sum(p["threads"] for p in pipes))]))
        fams.append(_fam("cb_pipeline_idle_seconds_total", COUNTER,
                         "host pipeline worker idle seconds",
                         [_scalar(sum(p["idle_s"] for p in pipes))]))
        stages: dict[str, dict] = {}
        for p in pipes:
            for st in p["stages"]:
                agg = stages.setdefault(
                    st["stage"], {"jobs": 0.0, "busy_s": 0.0,
                                  "nbytes": 0.0})
                agg["jobs"] += st["jobs"]
                agg["busy_s"] += st["busy_s"]
                agg["nbytes"] += st["nbytes"]
        for metric, key, help_ in (
                ("cb_pipeline_jobs_total", "jobs",
                 "host pipeline jobs run"),
                ("cb_pipeline_busy_seconds_total", "busy_s",
                 "host pipeline busy seconds"),
                ("cb_pipeline_bytes_total", "nbytes",
                 "host pipeline bytes processed")):
            fams.append(_fam(metric, COUNTER, help_, [
                _scalar(agg[key], stage=stage)
                for stage, agg in sorted(stages.items())]))

    healths = [h.stats().to_obj() for h in reg.sources("health")]
    if healths:
        hsum = _sum_rows(healths, ("hedges_fired", "hedges_won",
                                   "hedges_cancelled", "primaries"))
        for key in ("hedges_fired", "hedges_won", "hedges_cancelled"):
            fams.append(_fam(f"cb_{key}_total", COUNTER,
                             f"hedged reads: {key.replace('_', ' ')}",
                             [_scalar(hsum[key])]))
        # the budget denominator: the scoreboard's amplification bound
        # is fired <= ratio*primaries + burst, so fired/primaries held
        # at the slope means the budget is pinned at its cap
        fams.append(_fam("cb_hedge_primaries_total", COUNTER,
                         "primary (non-hedge) chunk fetches — the "
                         "hedge-budget accrual denominator",
                         [_scalar(hsum["primaries"])]))
        nodes: dict[str, dict] = {}
        for h in healths:
            for row in h["locations"]:
                # node keys come from cluster config (netloc / disk
                # root): a closed set, so legal as a label
                agg = nodes.get(row["node"])
                if agg is None:
                    nodes[row["node"]] = dict(row)
                else:
                    agg["completions"] += row["completions"]
                    agg["errors"] += row["errors"]
                    agg["inflight"] += row["inflight"]
        breaker_rank = {"closed": 0, "half-open": 1, "open": 2}
        for metric, kind, key, help_ in (
                ("cb_node_completions_total", COUNTER, "completions",
                 "location completions recorded"),
                ("cb_node_errors_total", COUNTER, "errors",
                 "location errors recorded"),
                ("cb_node_inflight", GAUGE, "inflight",
                 "location I/Os in flight"),
                ("cb_node_err_rate", GAUGE, "err_rate",
                 "location error-rate EWMA")):
            fams.append(_fam(metric, kind, help_, [
                _scalar(row[key], node=node)
                for node, row in sorted(nodes.items())]))
        fams.append(_fam(
            "cb_node_ewma_seconds", GAUGE,
            "location latency EWMA (successes)", [
                _scalar((row["ewma_ms"] or 0.0) / 1000.0, node=node)
                for node, row in sorted(nodes.items())]))
        fams.append(_fam(
            "cb_node_breaker_state", GAUGE,
            "breaker state (0 closed, 1 half-open, 2 open)", [
                _scalar(breaker_rank.get(row["breaker"], 2), node=node)
                for node, row in sorted(nodes.items())]))

    repairs = [r.stats().to_obj() for r in reg.sources("repair")]
    if repairs:
        # plan kinds, helper-read sources and erasure codes are closed
        # label sets: copy = 1x from a healthy replica, decode
        # = ranged reads off d helpers, msr = pm-msr β-projection
        # regeneration, fallback = handed to full resilver; codes come
        # from cluster.repair.CODES
        by_code: dict[str, dict] = {}
        for r in repairs:
            for code, counters in (r.get("by_code") or {}).items():
                agg = by_code.setdefault(code, {})
                for key, value in counters.items():
                    agg[key] = agg.get(key, 0.0) + float(value or 0)
        codes = sorted(by_code)
        fams.append(_fam("cb_repair_plans_total", COUNTER,
                         "repair plans executed by kind and code", [
                             _scalar(by_code[c].get(f"plans_{kind}", 0),
                                     kind=kind, code=c)
                             for c in codes
                             for kind in ("copy", "decode", "msr",
                                          "fallback")]))
        fams.append(_fam("cb_repair_helper_bytes_total", COUNTER,
                         "bytes read off helpers for repair by source "
                         "and code", [
                             _scalar(by_code[c].get(
                                 f"helper_bytes_{src}", 0),
                                 source=src, code=c)
                             for c in codes
                             for src in ("replica", "decode", "msr")]))
        for key, help_ in (
                ("bytes_localized",
                 "victim bytes re-read to localize damage"),
                ("bytes_rebuilt", "damaged bytes rebuilt in place"),
                ("bytes_written", "repair bytes written to victims"),
                ("ranges_rebuilt", "damaged ranges rebuilt"),
                ("verify_failures",
                 "rebuilt chunks failing the end-to-end hash gate")):
            fams.append(_fam(f"cb_repair_{key}_total", COUNTER,
                             f"repair planner: {help_}",
                             [_scalar(by_code[c].get(key, 0), code=c)
                              for c in codes]))

    scrubs = [s.stats().to_obj() for s in reg.sources("scrub")]
    if scrubs:
        s = _sum_rows(scrubs, ("passes", "files_scanned",
                               "chunks_scanned", "bytes_verified",
                               "corrupt", "unavailable", "repaired",
                               "repair_failures"))
        for key in ("passes", "files_scanned", "chunks_scanned",
                    "bytes_verified", "corrupt", "unavailable",
                    "repaired", "repair_failures"):
            fams.append(_fam(f"cb_scrub_{key}_total", COUNTER,
                             f"scrub {key.replace('_', ' ')}",
                             [_scalar(s[key])]))
        fams.append(_fam("cb_scrub_running", GAUGE,
                         "scrub daemon running", [_scalar(
                             sum(1 for x in scrubs if x["running"]))]))
        fams.append(_fam("cb_scrub_rate_bytes_per_sec", GAUGE,
                         "scrub byte-rate bound", [_scalar(
                             sum(x["rate_bytes_per_sec"]
                                 for x in scrubs))]))

    qoses = [q.stats().to_obj() for q in reg.sources("qos")]
    if qoses:
        # the ``tenant`` label values come from the scheduler's closed
        # table (named YAML tenants + "other", cluster/qos.py), so nothing
        # here can mint one; per-worker schedulers sum in the fleet merge
        tenants: dict[str, dict] = {}
        for q in qoses:
            for name, row in q["tenants"].items():
                agg = tenants.setdefault(
                    name, {"admitted": 0.0, "shed": 0.0, "bytes": 0.0,
                           "throttle_waits": 0.0, "queued": 0.0})
                for key in agg:
                    agg[key] += float(row.get(key, 0) or 0)
        for metric, key, kind, help_ in (
                ("cb_qos_admitted_total", "admitted", COUNTER,
                 "QoS admissions granted"),
                ("cb_qos_shed_total", "shed", COUNTER,
                 "QoS admissions shed (queue full / wait deadline)"),
                ("cb_qos_bytes_total", "bytes", COUNTER,
                 "QoS bytes admitted"),
                ("cb_qos_throttle_waits_total", "throttle_waits",
                 COUNTER, "QoS per-tenant rate-bucket waits"),
                ("cb_qos_queued", "queued", GAUGE,
                 "QoS waiters currently queued")):
            fams.append(_fam(metric, kind, help_, [
                _scalar(agg[key], tenant=tenant)
                for tenant, agg in sorted(tenants.items())]))
        qsum = _sum_rows(qoses, ("hedge_suppressed", "hedge_conserved"))
        fams.append(_fam("cb_qos_hedge_suppressed_total", COUNTER,
                         "hedge launches suppressed under admission "
                         "pressure", [_scalar(qsum["hedge_suppressed"])]))
        fams.append(_fam("cb_qos_hedge_conserved_total", COUNTER,
                         "hedge budget conserved on ample p99 headroom",
                         [_scalar(qsum["hedge_conserved"])]))
        fams.append(_fam("cb_qos_pressure", GAUGE,
                         "gateway admission pressure [0,1]",
                         [_scalar(max(q["pressure"] for q in qoses))]))

    scheds = [s.info() for s in reg.sources("xor_schedule")]
    if scheds:
        s = _sum_rows(scheds, ("hits", "misses", "evictions", "size"))
        for key in ("hits", "misses", "evictions"):
            fams.append(_fam(f"cb_xor_schedule_{key}_total", COUNTER,
                             f"scheduled-XOR program cache {key} "
                             "(ops/xor_schedule.py LRU)",
                             [_scalar(s[key])]))
        fams.append(_fam("cb_xor_schedule_entries", GAUGE,
                         "scheduled-XOR program cache entries",
                         [_scalar(s["size"])]))

    return fams


# ---- exposition ----


def _fmt(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace(
        "\n", "\\n")


def _label_str(labels: dict, extra: Optional[tuple[str, str]] = None
               ) -> str:
    items = sorted(labels.items())
    if extra is not None:
        items.append(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in items)
    return "{" + inner + "}"


def render_exposition(snapshot: dict) -> str:
    """Prometheus text exposition of a snapshot (one worker's, or the
    merged fleet's).  Histogram buckets cumulate here; every family
    gets exactly one HELP/TYPE pair."""
    lines: list[str] = []
    for fam in snapshot["families"]:
        name, kind = fam["name"], fam["type"]
        help_ = fam.get("help") or name
        lines.append(f"# HELP {name} "
                     f"{help_.replace(chr(10), ' ').strip()}")
        lines.append(f"# TYPE {name} {kind}")
        if kind == HISTOGRAM:
            bounds = fam.get("buckets") or []
            for s in fam["samples"]:
                cum = 0
                for bound, c in zip(list(bounds) + [math.inf],
                                    s["counts"]):
                    cum += c
                    le = "+Inf" if math.isinf(bound) else _fmt(bound)
                    lines.append(
                        f"{name}_bucket"
                        f"{_label_str(s['labels'], ('le', le))} {cum}")
                lines.append(f"{name}_sum{_label_str(s['labels'])} "
                             f"{_fmt(s['sum'])}")
                lines.append(f"{name}_count{_label_str(s['labels'])} "
                             f"{cum}")
        else:
            for s in fam["samples"]:
                lines.append(f"{name}{_label_str(s['labels'])} "
                             f"{_fmt(s['value'])}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(.*)\})?"
    r" (-?(?:[0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?|\+Inf|-Inf|NaN))$")
_LABEL_PAIR_RE = re.compile(
    r'^([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\["\\n])*)"$')


def _split_labels(raw: str, lineno: int) -> dict:
    labels: dict[str, str] = {}
    # split on commas outside quotes
    parts, buf, in_q, esc = [], [], False, False
    for ch in raw:
        if esc:
            buf.append(ch)
            esc = False
            continue
        if ch == "\\":
            buf.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
            buf.append(ch)
            continue
        if ch == "," and not in_q:
            parts.append("".join(buf))
            buf = []
            continue
        buf.append(ch)
    if buf:
        parts.append("".join(buf))
    for part in parts:
        m = _LABEL_PAIR_RE.match(part.strip())
        if not m:
            raise ExpositionError(
                f"line {lineno}: bad label pair {part!r}")
        if m.group(1) in labels:
            raise ExpositionError(
                f"line {lineno}: duplicate label {m.group(1)!r}")
        labels[m.group(1)] = m.group(2)
    return labels


def parse_exposition(text: str) -> dict:
    """Strict line-grammar check of a Prometheus text payload; raises
    :class:`ExpositionError` on any violation and returns
    ``{family: {"type", "samples": [(labels, value)]}}`` on success.
    The tests and the CI ``/metrics`` scrape step run this, so the
    grammar the gateway emits is pinned, not assumed.

    Beyond the per-line grammar it checks family-level invariants:
    every sample's base name carries a preceding TYPE, counter values
    are finite and non-negative, histogram bucket counts are cumulative
    non-decreasing over ascending ``le`` bounds ending at ``+Inf``, and
    ``_count`` equals the ``+Inf`` bucket."""
    types: dict[str, str] = {}
    helps: set[str] = set()
    samples: dict[str, list] = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name = rest.split(" ", 1)[0]
            if not _NAME_RE.match(name):
                raise ExpositionError(f"line {lineno}: bad HELP name")
            if name in helps:
                raise ExpositionError(
                    f"line {lineno}: duplicate HELP for {name}")
            helps.add(name)
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):].split(" ")
            if len(rest) != 2 or rest[1] not in (COUNTER, GAUGE,
                                                 HISTOGRAM):
                raise ExpositionError(f"line {lineno}: bad TYPE line")
            name = rest[0]
            if not _NAME_RE.match(name) or name in types:
                raise ExpositionError(
                    f"line {lineno}: bad/duplicate TYPE for {name}")
            types[name] = rest[1]
            continue
        if line.startswith("#"):
            raise ExpositionError(
                f"line {lineno}: unknown comment form")
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ExpositionError(f"line {lineno}: bad sample line "
                                  f"{line!r}")
        name, raw_labels, raw_value = m.groups()
        labels = _split_labels(raw_labels, lineno) if raw_labels else {}
        value = float(raw_value.replace("+Inf", "inf").replace(
            "-Inf", "-inf").replace("NaN", "nan"))
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            trimmed = name[: -len(suffix)] if name.endswith(suffix) \
                else None
            if trimmed and types.get(trimmed) == HISTOGRAM:
                base = trimmed
                break
        if base not in types:
            raise ExpositionError(
                f"line {lineno}: sample {name} has no TYPE")
        if types[base] == COUNTER and not (value >= 0
                                           and math.isfinite(value)):
            raise ExpositionError(
                f"line {lineno}: counter {name} value {raw_value}")
        samples.setdefault(base, []).append((name, labels, value))
    # histogram family invariants
    for base, kind in types.items():
        if kind != HISTOGRAM:
            continue
        rows = samples.get(base, [])
        series: dict[tuple, dict] = {}
        for name, labels, value in rows:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            st = series.setdefault(key, {"buckets": [], "sum": None,
                                         "count": None})
            if name == base + "_bucket":
                if "le" not in labels:
                    raise ExpositionError(
                        f"{base}_bucket missing le label")
                le = float(labels["le"].replace("+Inf", "inf"))
                st["buckets"].append((le, value))
            elif name == base + "_sum":
                st["sum"] = value
            elif name == base + "_count":
                st["count"] = value
        for key, st in series.items():
            bkts = st["buckets"]
            if not bkts or not math.isinf(bkts[-1][0]):
                raise ExpositionError(
                    f"{base}: histogram series must end at le=+Inf")
            les = [b[0] for b in bkts]
            counts = [b[1] for b in bkts]
            if les != sorted(les) or len(set(les)) != len(les):
                raise ExpositionError(f"{base}: le bounds not ascending")
            if counts != sorted(counts):
                raise ExpositionError(
                    f"{base}: bucket counts not cumulative")
            if st["sum"] is None or st["count"] is None:
                raise ExpositionError(f"{base}: missing _sum/_count")
            if st["count"] != counts[-1]:
                raise ExpositionError(
                    f"{base}: _count != le=+Inf bucket")
    out = {}
    for base, kind in types.items():
        out[base] = {"type": kind, "samples": samples.get(base, [])}
    return out


def find_family(snapshot: dict, name: str) -> Optional[dict]:
    """The one family-by-name lookup over a snapshot's ``families``
    list (the stats CLI's renderer reads through it)."""
    for fam in snapshot.get("families", ()):
        if fam.get("name") == name:
            return fam
    return None


def histogram_quantile(bounds: Sequence[float], counts: Sequence[int],
                       q: float) -> float:
    """Approximate quantile from per-bucket (non-cumulative) counts —
    linear interpolation inside the winning bucket, like the percentile
    helper in file/profiler.py but over aggregated buckets instead of
    raw samples (the fleet view has no raw samples)."""
    total = sum(counts)
    if total <= 0:
        return 0.0
    rank = (q / 100.0) * total
    cum = 0.0
    lo = 0.0
    for bound, c in zip(list(bounds) + [math.inf], counts):
        if c > 0 and cum + c >= rank:
            hi = bound if math.isfinite(bound) else lo * 2 or 1.0
            frac = (rank - cum) / c
            return lo + (hi - lo) * min(max(frac, 0.0), 1.0)
        cum += c
        if math.isfinite(bound):
            lo = bound
    return lo


# ---- fleet aggregation (the multi-worker gateway's merge) ----


def merge_snapshots(entries: Sequence[tuple[Optional[str], dict]]
                    ) -> dict:
    """Aggregate per-worker snapshots into one fleet view: counters and
    histograms SUM by (name, labels); gauges gain a ``worker`` label so
    per-worker levels stay distinguishable (summing cache sizes across
    partitioned caches would hide one worker's runaway).  ``entries``
    is ``[(worker_id, snapshot)]``; a worker_id of None leaves gauges
    unlabeled (the single-process case)."""
    fams: dict[str, dict] = {}
    for worker_id, snap in entries:
        for fam in snap.get("families", ()):
            name, kind = fam["name"], fam["type"]
            out = fams.get(name)
            if out is None:
                out = fams[name] = {
                    "name": name, "type": kind,
                    "help": fam.get("help", ""), "samples": [],
                    "_index": {}}
                if "buckets" in fam:
                    out["buckets"] = list(fam["buckets"])
            if out["type"] != kind:
                raise ValueError(f"{name}: type mismatch across workers")
            if kind == HISTOGRAM and out.get("buckets") != list(
                    fam.get("buckets", [])):
                raise ValueError(
                    f"{name}: bucket layout mismatch across workers")
            for s in fam["samples"]:
                labels = dict(s["labels"])
                if kind == GAUGE and worker_id is not None:
                    labels["worker"] = str(worker_id)
                key = tuple(sorted(labels.items()))
                existing = out["_index"].get(key)
                if existing is None:
                    merged = {"labels": labels}
                    if kind == HISTOGRAM:
                        merged["counts"] = list(s["counts"])
                        merged["sum"] = s["sum"]
                        merged["count"] = s.get(
                            "count", sum(s["counts"]))
                    else:
                        merged["value"] = s["value"]
                    out["_index"][key] = merged
                    out["samples"].append(merged)
                elif kind == HISTOGRAM:
                    existing["counts"] = [
                        a + b for a, b in zip(existing["counts"],
                                              s["counts"])]
                    existing["sum"] += s["sum"]
                    existing["count"] += s.get("count",
                                               sum(s["counts"]))
                else:  # counters sum; same-label gauges sum too
                    existing["value"] += s["value"]
    out_fams = []
    for name in sorted(fams):
        fam = fams[name]
        fam.pop("_index")
        fam["samples"].sort(key=lambda s: sorted(s["labels"].items()))
        out_fams.append(fam)
    return {"families": out_fams}


# ---- snapshot spool (per-worker files the fleet merge reads) ----


def write_snapshot_file(path: str, snapshot: dict) -> None:
    """Atomically publish one worker's snapshot (tmp + rename, the same
    publication discipline as chunk files).  Blocking — call off-loop."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(snapshot, f, separators=(",", ":"))
    os.replace(tmp, path)


def load_spool(spool_dir: str) -> list[tuple[str, dict]]:
    """Read every worker snapshot in the spool; corrupt/torn files are
    skipped (the writer republishes within a heartbeat).  Blocking —
    call off-loop."""
    out: list[tuple[str, dict]] = []
    try:
        names = sorted(os.listdir(spool_dir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("worker-") and name.endswith(".json")):
            continue
        wid = name[len("worker-"):-len(".json")]
        try:
            with open(os.path.join(spool_dir, name)) as f:
                snap = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(snap, dict) and "families" in snap:
            out.append((wid, snap))
    return out


def fleet_snapshot(spool_dir: str,
                   own: Optional[tuple[str, dict]] = None) -> dict:
    """The merged fleet snapshot: every spooled worker snapshot, with
    ``own`` (the scraped worker's LIVE snapshot) replacing its possibly
    stale spool entry.  Blocking — call off-loop."""
    entries = load_spool(spool_dir)
    if own is not None:
        entries = [(wid, snap) for wid, snap in entries
                   if wid != own[0]]
        entries.append(own)
    return merge_snapshots(entries)


# ---- event-loop lag (the always-on cousin of the sanitizer watchdog) ----


class LoopLagMonitor:
    """Cheap always-on event-loop scheduling-delay sampler: a chained
    ``call_later`` measures how late each tick fires and feeds the
    ``cb_eventloop_lag_seconds`` histogram — the production-grade
    cousin of the opt-in sanitizer's stall watchdog (which needs a
    whole sampling thread because it must catch a loop that never runs
    callbacks at all; this one just prices the delay of a loop that
    does).  A timer handle, not a task — nothing to leak, nothing for
    the task registry to track."""

    INTERVAL = 0.25

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 interval: float = INTERVAL) -> None:
        self._hist = (registry or get_registry()).histogram(
            "cb_eventloop_lag_seconds",
            "event-loop callback scheduling delay")
        self._interval = interval
        self._handle = None
        self._loop = None
        self._expected = 0.0
        self._stopped = False

    def start(self, loop) -> None:
        self._loop = loop
        # loop lag is defined against the loop's own clock
        # lint: clock-escape-ok loop lag is defined against the loop's
        # OWN clock; under sim the virtual loop makes this virtual too
        self._expected = loop.time() + self._interval
        self._handle = loop.call_later(self._interval, self._tick)

    def _tick(self) -> None:
        if self._stopped or self._loop is None:
            return
        now = self._loop.time()
        self._hist.observe(max(now - self._expected, 0.0))
        self._expected = now + self._interval
        self._handle = self._loop.call_later(self._interval, self._tick)

    def stop(self) -> None:
        self._stopped = True
        if self._handle is not None:
            self._handle.cancel()
            self._handle = None
