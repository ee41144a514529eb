"""Multi-tenant QoS: weighted-fair admission and priority classes (the
port of ``chunky_bits_tpu/cluster/qos.py``).

Without it the gateway sheds load globally (503 past
``max_concurrent_gets``), so one hot tenant starves everyone.  This module
is the per-tenant scheduler the serving plane puts in front of GET body
streaming and PUT ingest:

**Closed, bounded tenant table.**  Tenants are named in config (the YAML
``qos:`` mapping: API keys and/or path prefixes per tenant) plus exactly
one ``other`` bucket for everything unmatched.  Resolution never mints a
tenant at runtime: a client rotating 10k API keys still lands in
``other``, and the ``tenant`` metric label stays a closed set far under
``MAX_LABEL_SETS`` (:data:`MAX_TENANTS` named tenants + ``other``).

**Deficit round robin** (Shreedhar & Varghese, SIGCOMM '95).  Each class
("read", "write") has a concurrency capacity; when it is saturated,
arrivals queue per tenant and grants rotate tenants, crediting each visit
``weight x QUANTUM`` bytes of deficit and releasing waiters while their
byte cost fits.  Cost is the response (or request) byte size, so fairness
is measured in bytes served, not request count.  Optional per-tenant
byte-rate ``TokenBucket``s (the scrub daemon's bucket, clock-seam timed)
bound sustained throughput before a slot is contended.

**Priority classes: client reads > writes > hedges > scrub/repair.**
Reads never wait on writes (separate capacities); write grants are
deferred while read waiters queue (:meth:`QosScheduler._write_gated`); the
:meth:`pressure` signal (read in-flight / capacity, saturating to 1.0 once
readers queue) feeds two downstream throttles the gateway wires up: the
scrub/repair ``TokenBucket.set_pressure`` hook and the scoreboard's hedge
gate (:meth:`allow_hedge`), so background I/O and speculative hedge load
yield before client traffic queues.

**SLO-aware hedging.**  ``allow_hedge`` spends the scoreboard's hedge
budget where p99 headroom is worst: under admission pressure hedges are
suppressed; with ample read-p99 headroom (observed p99 below half the
objective, from the ``note_request`` samples the access log feeds) the
budget is conserved.  No signal (cold ring) means allow.

**Degrade, never hang**: a queued waiter is bounded by
``QUEUE_TIMEOUT_S`` through ``asyncio.wait_for``, so a wedged scheduler
sheds (503) instead of parking requests forever.

Loop discipline: queue state is mutated only from the owning event loop
(the gateway is single-loop per worker); counters are plain ints read
lock-free by ``stats()`` and the metrics adapter.  Time goes through the
clock seam, so the same scheduler runs in compressed virtual time under
``sim.run``.

Off by default (``tunables.qos_enabled`` / ``$CHUNKY_BITS_TORCH_QOS``; the
YAML ``qos.enabled`` wins when present): nothing constructs a scheduler
until the gateway asks.
"""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass
from typing import Optional

from chunky_bits_tpu_torch.cluster import clock as _clock
from chunky_bits_tpu_torch.cluster.scrub import TokenBucket
from chunky_bits_tpu_torch.obs import metrics as obs_metrics

__all__ = [
    "MAX_TENANTS",
    "OTHER",
    "QosConfig",
    "QosScheduler",
    "QosShedError",
    "QosStats",
    "TenantSpec",
]

#: the reserved catch-all tenant — always present, never configurable
#: beyond its weight; unmatched keys/paths land here so the tenant
#: label set is closed by construction
OTHER = "other"

#: hard bound on *named* tenants (plus ``other``) — keeps the
#: per-tenant metric families far under ``MAX_LABEL_SETS`` even with
#: the class dimension multiplied in
MAX_TENANTS = 32

#: DRR quantum per unit weight, bytes.  One weight-1 visit credits a
#: typical chunk-sized response; costs above the quantum simply take
#: several rotations to accrue (classic DRR latency behavior).
QUANTUM = 64 * 1024

#: nominal cost when the byte size is unknown (PUT without
#: Content-Length, HEAD-shaped internals) — one quantum, so unknown
#: costs neither starve nor dominate a rotation
DEFAULT_COST = QUANTUM

#: per-tenant queue bound — arrivals past this shed (503) instead of
#: queueing; bounds waiter memory AND worst-case queue latency
MAX_QUEUE = 64

#: admission-wait deadline ("degrade, never hang"): a waiter not
#: granted within this window sheds instead of parking forever
QUEUE_TIMEOUT_S = 30.0

#: pressure at/above which hedge launches are suppressed — half the
#: read capacity in flight means speculative load is about to compete
#: with client traffic
HEDGE_SUPPRESS_PRESSURE = 0.5

#: latency samples per class for the SLO-aware hedge advisor (matches
#: the scoreboard's SAMPLE_WINDOW scale)
SAMPLE_WINDOW = 128

#: below this many read samples the advisor has no p99 signal and
#: allows hedging (the pre-QoS default)
MIN_SAMPLES = 16

#: admission classes — also the closed value set of the ``class``
#: metric label
CLASSES = ("read", "write")


class QosShedError(Exception):
    """Admission refused: per-tenant queue full or wait deadline hit.
    The gateway maps this to 503 + derived ``Retry-After``."""


@dataclass(frozen=True)
class TenantSpec:
    """One named tenant from the YAML ``qos:`` mapping."""

    name: str
    weight: float = 1.0
    #: sustained byte-rate bound, 0 = unbounded
    rate_bytes_per_sec: float = 0.0
    #: exact API-key matches (``X-Api-Key`` header)
    keys: tuple = ()
    #: path prefixes (longest match wins across tenants)
    prefixes: tuple = ()


def _spec_from_obj(name: str, obj: object) -> TenantSpec:
    if not isinstance(obj, dict):
        raise ValueError(f"tenant {name!r}: expected a mapping, "
                         f"got {type(obj).__name__}")
    unknown = set(obj) - {"weight", "rate_bytes_per_sec", "keys",
                          "prefixes"}
    if unknown:
        raise ValueError(
            f"tenant {name!r}: unknown keys {sorted(unknown)}")
    weight = obj.get("weight", 1.0)
    if not isinstance(weight, (int, float)) or isinstance(weight, bool) \
            or weight < 1:
        raise ValueError(f"tenant {name!r}: weight must be a number "
                         f">= 1, got {weight!r}")
    rate = obj.get("rate_bytes_per_sec", 0.0)
    if not isinstance(rate, (int, float)) or isinstance(rate, bool) \
            or rate < 0:
        raise ValueError(f"tenant {name!r}: rate_bytes_per_sec must "
                         f"be a number >= 0, got {rate!r}")
    keys = obj.get("keys", ())
    prefixes = obj.get("prefixes", ())
    for label, seq in (("keys", keys), ("prefixes", prefixes)):
        if not isinstance(seq, (list, tuple)) \
                or not all(isinstance(s, str) and s for s in seq):
            raise ValueError(f"tenant {name!r}: {label} must be a "
                             "list of non-empty strings")
    return TenantSpec(name=name, weight=float(weight),
                      rate_bytes_per_sec=float(rate),
                      keys=tuple(keys), prefixes=tuple(prefixes))


@dataclass(frozen=True)
class QosConfig:
    """Parsed+validated ``qos:`` mapping: the closed tenant table and
    the resolution maps.  ``enabled`` tri-state: True/False from YAML,
    None = defer to ``tunables.qos_enabled()`` (the env flag)."""

    tenants: tuple = ()
    enabled: Optional[bool] = None
    other_weight: float = 1.0

    @classmethod
    def from_obj(cls, obj: object) -> "QosConfig":
        """Loud validation (unknown keys raise) — the same contract as
        ``SloObjectives.from_obj``; ``cluster/tunables.py`` wraps the
        ValueError in a SerdeError with the config path context."""
        if not isinstance(obj, dict):
            raise ValueError(
                f"expected a mapping, got {type(obj).__name__}")
        unknown = set(obj) - {"enabled", "tenants", OTHER}
        if unknown:
            raise ValueError(f"unknown keys {sorted(unknown)} "
                             f"(expected enabled/tenants/{OTHER})")
        enabled = obj.get("enabled")
        if enabled is not None and not isinstance(enabled, bool):
            raise ValueError(
                f"enabled must be a bool, got {enabled!r}")
        other_weight = 1.0
        other_v = obj.get(OTHER)
        if other_v is not None:
            if not isinstance(other_v, dict) \
                    or set(other_v) - {"weight"}:
                raise ValueError(
                    f"{OTHER!r} accepts only a weight mapping")
            other_weight = other_v.get("weight", 1.0)
            if not isinstance(other_weight, (int, float)) \
                    or isinstance(other_weight, bool) \
                    or other_weight < 1:
                raise ValueError(f"{OTHER!r}: weight must be a number "
                                 f">= 1, got {other_weight!r}")
        tenants_v = obj.get("tenants", {})
        if not isinstance(tenants_v, dict):
            raise ValueError("tenants must be a mapping of "
                             "name -> tenant spec")
        if len(tenants_v) > MAX_TENANTS:
            raise ValueError(f"{len(tenants_v)} named tenants exceeds "
                             f"MAX_TENANTS={MAX_TENANTS}")
        specs = []
        seen_keys: dict = {}
        for name, spec_obj in tenants_v.items():
            if not isinstance(name, str) or not name:
                raise ValueError(
                    f"tenant names must be non-empty strings, "
                    f"got {name!r}")
            if name == OTHER:
                raise ValueError(
                    f"{OTHER!r} is reserved (configure its weight "
                    f"under the top-level {OTHER!r} key)")
            spec = _spec_from_obj(name, spec_obj)
            for key in spec.keys:
                if key in seen_keys:
                    raise ValueError(
                        f"api key {key!r} claimed by both "
                        f"{seen_keys[key]!r} and {name!r}")
                seen_keys[key] = name
            specs.append(spec)
        return cls(tenants=tuple(specs), enabled=enabled,
                   other_weight=float(other_weight))

    def __post_init__(self) -> None:
        by_key = {}
        prefixes = []
        for spec in self.tenants:
            for key in spec.keys:
                by_key[key] = spec.name
            for prefix in spec.prefixes:
                prefixes.append((prefix, spec.name))
        # longest prefix wins; resolution scans in sorted order
        prefixes.sort(key=lambda kv: len(kv[0]), reverse=True)
        object.__setattr__(self, "_by_key", by_key)
        object.__setattr__(self, "_prefixes", tuple(prefixes))

    def resolve(self, api_key: Optional[str], path: str) -> str:
        """Tenant for a request: exact API-key match wins, else the
        longest matching path prefix, else ``other``.  Total: every
        (key, path) maps to exactly one tenant in the closed table."""
        if api_key:
            name = self._by_key.get(api_key)
            if name is not None:
                return name
        for prefix, name in self._prefixes:
            if path.startswith(prefix):
                return name
        return OTHER

    def tenant_names(self) -> tuple:
        """The CLOSED tenant label set: every configured name plus
        ``other`` — nothing else can ever appear on a metric."""
        return tuple(s.name for s in self.tenants) + (OTHER,)

    def to_obj(self) -> dict:
        obj: dict = {}
        if self.enabled is not None:
            obj["enabled"] = self.enabled
        if self.other_weight != 1.0:
            obj[OTHER] = {"weight": self.other_weight}
        tenants = {}
        for s in self.tenants:
            row: dict = {}
            if s.weight != 1.0:
                row["weight"] = s.weight
            if s.rate_bytes_per_sec:
                row["rate_bytes_per_sec"] = s.rate_bytes_per_sec
            if s.keys:
                row["keys"] = list(s.keys)
            if s.prefixes:
                row["prefixes"] = list(s.prefixes)
            tenants[s.name] = row
        if tenants:
            obj["tenants"] = tenants
        return obj


@dataclass
class TenantRow:
    """Per-tenant counter snapshot (one ``Qos<...>`` stanza row, one
    label set per ``cb_qos_*`` family)."""

    tenant: str
    admitted: int
    shed: int
    bytes: int
    throttle_waits: int
    queued: int
    queue_peak: int

    def to_obj(self) -> dict:
        return {
            "admitted": self.admitted,
            "shed": self.shed,
            "bytes": self.bytes,
            "throttle_waits": self.throttle_waits,
            "queued": self.queued,
            "queue_peak": self.queue_peak,
        }


@dataclass
class QosStats:
    """Scheduler snapshot — the ``Qos<...>`` profiler stanza, the
    ``/stats`` qos stanza, and the ``cb_qos_*`` metric families all
    read THIS (one set of numbers everywhere)."""

    enabled: bool
    pressure: float
    hedge_suppressed: int
    hedge_conserved: int
    read_in_flight: int
    write_in_flight: int
    rows: tuple = ()

    def to_obj(self) -> dict:
        return {
            "enabled": self.enabled,
            "pressure": round(self.pressure, 4),
            "hedge_suppressed": self.hedge_suppressed,
            "hedge_conserved": self.hedge_conserved,
            "read_in_flight": self.read_in_flight,
            "write_in_flight": self.write_in_flight,
            "tenants": {r.tenant: r.to_obj() for r in self.rows},
        }

    def __str__(self) -> str:
        rows = ", ".join(
            f"{r.tenant}: adm={r.admitted} shed={r.shed} "
            f"q={r.queued}/{r.queue_peak}" for r in self.rows)
        return (f"Qos<pressure={self.pressure:.2f}, "
                f"in_flight={self.read_in_flight}r/"
                f"{self.write_in_flight}w, "
                f"hedge_suppressed={self.hedge_suppressed}, "
                f"{rows}>")


class _TenantState:
    """Mutable per-tenant scheduler state (loop-confined)."""

    __slots__ = ("name", "weight", "bucket", "deficit", "queues",
                 "admitted", "shed", "bytes", "throttle_waits",
                 "queue_peak")

    def __init__(self, name: str, weight: float,
                 rate: float = 0.0) -> None:
        self.name = name
        self.weight = max(float(weight), 1.0)
        self.bucket = TokenBucket(rate) if rate > 0 else None
        self.deficit = {cls: 0.0 for cls in CLASSES}
        #: per-class FIFO of [future, cost] waiter records
        self.queues = {cls: deque() for cls in CLASSES}
        self.admitted = 0
        self.shed = 0
        self.bytes = 0
        self.throttle_waits = 0
        self.queue_peak = 0


class QosScheduler:
    """Weighted-fair (DRR) admission over the closed tenant table.

    One per gateway worker (caches and scoreboards are per worker by
    design).  Self-registers as a ``"qos"`` stats source, so
    ``/metrics`` folds the ``cb_qos_*`` families in with no wiring."""

    def __init__(self, config: QosConfig, *,
                 read_capacity: int = 256,
                 write_capacity: int = 32,
                 max_queue: int = MAX_QUEUE,
                 queue_timeout_s: float = QUEUE_TIMEOUT_S,
                 read_p99_objective_ms: float = 500.0) -> None:
        self.config = config
        self._capacity = {"read": max(int(read_capacity), 1),
                          "write": max(int(write_capacity), 1)}
        self._in_flight = {cls: 0 for cls in CLASSES}
        self._max_queue = max(int(max_queue), 1)
        self._queue_timeout_s = float(queue_timeout_s)
        self._read_p99_objective_ms = float(read_p99_objective_ms)
        self._tenants: dict = {}
        for spec in config.tenants:
            self._tenants[spec.name] = _TenantState(
                spec.name, spec.weight, spec.rate_bytes_per_sec)
        self._tenants[OTHER] = _TenantState(OTHER, config.other_weight)
        #: DRR rotation order per class (index into _order)
        self._order = tuple(self._tenants.values())
        self._rotor = {cls: 0 for cls in CLASSES}
        #: per-class completion-latency rings for the hedge advisor
        self._latency = {cls: deque(maxlen=SAMPLE_WINDOW)
                         for cls in CLASSES}
        self.hedge_suppressed = 0
        self.hedge_conserved = 0
        obs_metrics.get_registry().register_source("qos", self)

    # ---- admission ----

    def queued(self, cls: str) -> int:
        """Waiters currently queued in ``cls`` across all tenants
        (the gateway's derived Retry-After counts them as 'ahead')."""
        return sum(len(t.queues[cls]) for t in self._order)

    def _write_gated(self) -> bool:
        """Priority: client reads > writes — defer write grants while
        read waiters queue (writes already admitted keep running)."""
        return self.queued("read") > 0

    async def acquire(self, cls: str, tenant: str,
                      cost: Optional[int] = None) -> None:
        """Admit one ``cls`` request for ``tenant`` costing ``cost``
        bytes (None = :data:`DEFAULT_COST`).  Returns when a slot is
        granted; raises :class:`QosShedError` when the tenant queue is
        full or the wait deadline passes.  MUST be paired with
        :meth:`release` (the gateway does it in a finally)."""
        state = self._tenants.get(tenant) or self._tenants[OTHER]
        nbytes = DEFAULT_COST if cost is None else max(int(cost), 1)
        if state.bucket is not None:
            t0 = _clock.monotonic()
            await state.bucket.take(nbytes)
            if _clock.monotonic() - t0 > 0:
                state.throttle_waits += 1
        gated = cls == "write" and self._write_gated()
        if (not gated and self.queued(cls) == 0
                and self._in_flight[cls] < self._capacity[cls]):
            # fast path: nothing queued anywhere in this class — a
            # grant here cannot jump any tenant's line
            self._grant(state, cls, nbytes)
            return
        if len(state.queues[cls]) >= self._max_queue:
            state.shed += 1
            raise QosShedError(
                f"tenant {state.name!r} {cls} queue full "
                f"({self._max_queue})")
        fut: asyncio.Future = \
            asyncio.get_running_loop().create_future()
        record = [fut, nbytes]
        state.queues[cls].append(record)
        depth = len(state.queues[cls])
        if depth > state.queue_peak:
            state.queue_peak = depth
        try:
            await asyncio.wait_for(fut, self._queue_timeout_s)
        except asyncio.TimeoutError:
            # degrade, never hang: shed instead of parking forever
            self._discard(state, cls, record)
            state.shed += 1
            raise QosShedError(
                f"tenant {state.name!r} {cls} admission wait "
                f"exceeded {self._queue_timeout_s:.0f}s") from None
        except asyncio.CancelledError:
            # caller gone (client disconnect): leave the line, and if
            # the grant already landed give the slot back
            granted = fut.done() and not fut.cancelled()
            self._discard(state, cls, record)
            if granted:
                self.release(cls)
            raise

    @staticmethod
    def _discard(state: "_TenantState", cls: str, record: list) -> None:
        try:
            state.queues[cls].remove(record)
        except ValueError:
            pass  # already granted+popped

    def _grant(self, state: "_TenantState", cls: str,
               nbytes: int) -> None:
        self._in_flight[cls] += 1
        state.admitted += 1
        state.bytes += nbytes

    def release(self, cls: str) -> None:
        """Return one ``cls`` slot and run the DRR grant pass."""
        self._in_flight[cls] = max(self._in_flight[cls] - 1, 0)
        self._kick(cls)
        if cls == "read" and not self._write_gated():
            # read queue drained: un-gate deferred writes
            self._kick("write")

    def _kick(self, cls: str) -> None:
        """DRR grant pass: rotate tenants, credit weight x QUANTUM per
        visit, grant while the head waiter's cost fits the deficit and
        capacity remains.  A tenant with an empty queue forfeits its
        deficit (classic DRR — credit never accrues while idle)."""
        if cls == "write" and self._write_gated():
            return
        n = len(self._order)
        idle_streak = 0
        while (self._in_flight[cls] < self._capacity[cls]
                and idle_streak < n):
            state = self._order[self._rotor[cls] % n]
            queue = state.queues[cls]
            # drop waiters whose future died (timeout/disconnect races)
            while queue and queue[0][0].done():
                queue.popleft()
            if not queue:
                state.deficit[cls] = 0.0
                self._rotor[cls] += 1
                idle_streak += 1
                continue
            state.deficit[cls] += state.weight * QUANTUM
            granted_any = False
            while (queue
                    and self._in_flight[cls] < self._capacity[cls]
                    and queue[0][1] <= state.deficit[cls]):
                fut, nbytes = queue.popleft()
                if fut.done():
                    continue
                state.deficit[cls] -= nbytes
                self._grant(state, cls, nbytes)
                fut.set_result(None)
                granted_any = True
            if not queue:
                state.deficit[cls] = 0.0
            self._rotor[cls] += 1
            idle_streak = 0 if granted_any else idle_streak + 1
        if self._in_flight[cls] == 0:
            # work-conserving escape: with the pipe idle there is no
            # future release() to run another grant pass, so a waiter
            # whose cost out-sizes one rotation's deficit credit would
            # park until the shed deadline.  Serving it outright is
            # strictly better than idling — grant the next head in
            # rotor order regardless of deficit.
            for _ in range(n):
                state = self._order[self._rotor[cls] % n]
                self._rotor[cls] += 1
                queue = state.queues[cls]
                while queue and queue[0][0].done():
                    queue.popleft()
                if queue:
                    fut, nbytes = queue.popleft()
                    state.deficit[cls] = 0.0
                    self._grant(state, cls, nbytes)
                    fut.set_result(None)
                    break

    # ---- pressure + hedge advisor ----

    def pressure(self) -> float:
        """Gateway pressure in [0, 1]: read slots in flight over
        capacity, saturating to 1.0 the moment readers queue.  Feeds
        the scrub/repair bucket throttle and the hedge gate."""
        if self.queued("read") > 0:
            return 1.0
        return min(self._in_flight["read"] / self._capacity["read"],
                   1.0)

    def note_request(self, cls: str, duration_s: float) -> None:
        """Completion-latency sample from the access log — the hedge
        advisor's p99 signal (same numbers the profiler logs)."""
        ring = self._latency.get(cls)
        if ring is not None:
            ring.append(float(duration_s))

    def _read_p99_ms(self) -> Optional[float]:
        ring = self._latency["read"]
        if len(ring) < MIN_SAMPLES:
            return None
        ordered = sorted(ring)
        # same nearest-rank shape as file/profiler.percentile, inline
        # to keep this module import-light
        idx = min(int(len(ordered) * 0.99), len(ordered) - 1)
        return ordered[idx] * 1000.0

    def allow_hedge(self) -> bool:
        """The scoreboard's hedge gate: suppress speculative load
        under admission pressure; with ample read-p99 headroom,
        conserve the budget for when the tail threatens the
        objective.  No signal -> allow (pre-QoS behavior)."""
        if self.pressure() >= HEDGE_SUPPRESS_PRESSURE:
            self.hedge_suppressed += 1
            return False
        p99_ms = self._read_p99_ms()
        if p99_ms is not None \
                and p99_ms <= 0.5 * self._read_p99_objective_ms:
            self.hedge_conserved += 1
            return False
        return True

    # ---- stats ----

    def stats(self) -> QosStats:
        rows = tuple(
            TenantRow(
                tenant=t.name, admitted=t.admitted, shed=t.shed,
                bytes=t.bytes, throttle_waits=t.throttle_waits,
                queued=sum(len(q) for q in t.queues.values()),
                queue_peak=t.queue_peak)
            for t in self._order)
        return QosStats(
            enabled=True, pressure=self.pressure(),
            hedge_suppressed=self.hedge_suppressed,
            hedge_conserved=self.hedge_conserved,
            read_in_flight=self._in_flight["read"],
            write_in_flight=self._in_flight["write"],
            rows=rows)
