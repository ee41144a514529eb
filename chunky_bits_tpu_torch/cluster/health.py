"""Per-location health scoreboard: the network plane's I/O scheduler state
(the port of ``chunky_bits_tpu/cluster/health.py``).

The reference walks ``chunk.locations`` in metadata order with no memory
of past behaviour (src/file/file_part.rs:83-101) and its writer reacts
only to hard errors (src/cluster/writer.rs:99-122).  The JAX package
added a per-location scoreboard that remembers EWMA latency, error rate
and in-flight counts for every storage node, and two mechanisms on top:

* a **closed -> open -> half-open breaker** per location, so a node
  that keeps failing stops being anyone's first choice until a probe
  succeeds (the read path still falls through to open-breaker nodes as
  a last resort: with data at stake, "degrade, never refuse");
* the **hedge machinery** for tail-tolerant reads (Dean & Barroso,
  "The Tail at Scale"): an adaptive hedge delay (p95 of recent
  latencies, clamped to ``[hedge_ms, 20*hedge_ms]``) and a global
  token-bucket budget capping hedges at ~``hedge_ratio`` (default 5%)
  of primary requests, so hedging can never amplify load meaningfully.

Health is tracked per **node**, not per URL: chunk addresses are unique
per object, so the key collapses an HTTP location to its netloc and a
local location to its parent directory — the unit that actually fails
or slows down.

Thread-safety: completions are recorded from event-loop callbacks and
from host-pipeline worker threads (the fused mmap+verify path runs the
mapper off-loop), so all bookkeeping is guarded by a ``threading.Lock``
held only for sync dict/float updates, never across an await and never
around I/O or sleeps.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from dataclasses import dataclass
from typing import Callable, Optional, Sequence
from urllib.parse import urlsplit

from chunky_bits_tpu_torch.cluster import clock as _clock

#: re-exported for callers that think in scheduler terms; the
#: definitions live in errors.py so file/ modules can use them without
#: importing the cluster package
from chunky_bits_tpu_torch.errors import (  # noqa: F401
    TRANSIENT_HTTP_STATUSES,
    is_transient_error,
)


def location_key(location) -> tuple[str, str]:
    """The health-tracking identity of a location: the storage *node*
    behind it.  HTTP chunks collapse to their netloc, local chunks to
    their parent directory (the node's disk root in every cluster
    layout this repo generates)."""
    target = location.target
    if location.kind == "http":
        return ("http", urlsplit(target).netloc)
    return ("local", os.path.dirname(target))


#: breaker states (string-valued for cheap rendering/tests)
CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half-open"


class _Node:
    """Mutable per-key record; all access under the scoreboard lock."""

    __slots__ = ("ewma", "err", "inflight", "consec_failures",
                 "breaker", "opened_at", "reads", "errors")

    def __init__(self) -> None:
        self.ewma: Optional[float] = None  # seconds, successes only
        self.err = 0.0  # EWMA of the failure indicator (0..1)
        self.inflight = 0
        self.consec_failures = 0
        self.breaker = CLOSED
        self.opened_at = 0.0
        self.reads = 0  # completions recorded (either verb)
        self.errors = 0


@dataclass
class LocationHealth:
    """Immutable snapshot row for reports/tests."""

    key: tuple[str, str]
    ewma_ms: Optional[float]
    err_rate: float
    inflight: int
    breaker: str
    completions: int
    errors: int

    def to_obj(self) -> dict:
        """Plain-dict row (the metrics registry's health collector and
        the ``chunky-bits stats`` renderer; ``node`` is the config-
        derived key, a closed label set)."""
        return {
            "node": self.key[1],
            "kind": self.key[0],
            "ewma_ms": (None if self.ewma_ms is None
                        else round(self.ewma_ms, 3)),
            "err_rate": round(self.err_rate, 4),
            "inflight": self.inflight,
            "breaker": self.breaker,
            "completions": self.completions,
            "errors": self.errors,
        }

    def __str__(self) -> str:
        ewma = "-" if self.ewma_ms is None else f"{self.ewma_ms:.1f}ms"
        return (f"{self.key[1]}: ewma={ewma} "
                f"err={self.err_rate * 100:.0f}% "
                f"inflight={self.inflight} breaker={self.breaker} "
                f"n={self.completions}")


@dataclass
class HealthStats:
    """Scoreboard snapshot surfaced through ``file/profiler.py``."""

    locations: list[LocationHealth]
    hedges_fired: int
    hedges_won: int
    hedges_cancelled: int
    #: primary (non-hedge) fetches that accrued hedge budget — the
    #: denominator of the hedge-amplification bound the simulator's
    #: thundering-herd scenario asserts (fired <= ratio*primaries+burst)
    primaries: int = 0

    def to_obj(self) -> dict:
        return {
            "locations": [row.to_obj() for row in self.locations],
            "hedges_fired": self.hedges_fired,
            "hedges_won": self.hedges_won,
            "hedges_cancelled": self.hedges_cancelled,
            "primaries": self.primaries,
        }

    def __str__(self) -> str:
        rows = "; ".join(str(r) for r in self.locations) or "no traffic"
        return (f"Health<{rows} | hedges fired={self.hedges_fired} "
                f"won={self.hedges_won} "
                f"cancelled={self.hedges_cancelled}>")


class HealthScoreboard:
    """Loop-safe per-location scoreboard + hedge budget.

    One instance per cluster (``Cluster.__init__`` hangs it on the
    shared ``LocationContext``), shared by every event loop and worker
    thread that touches the cluster — health memory must span loops,
    unlike the loop-bound batchers/caches.  NOT ``LOOP_BOUND``: every
    method is a sub-microsecond sync update under ``self._lock``.
    """

    #: EWMA smoothing for latency and error rate
    ALPHA = 0.2
    #: consecutive failures that trip the breaker closed -> open
    BREAKER_FAILURES = 5
    #: seconds an open breaker waits before allowing a half-open probe
    BREAKER_COOLDOWN = 5.0
    #: error-rate EWMA above which a node counts as degraded for
    #: placement de-prioritization even before its breaker trips
    DEGRADED_ERR = 0.5
    #: adaptive hedge delay ceiling, as a multiple of the floor
    CEILING_FACTOR = 20.0
    #: recent success latencies pooled for the p95 hedge delay
    SAMPLE_WINDOW = 128

    def __init__(self, hedge_ms: float = 0.0,
                 hedge_ratio: float = 0.05,
                 hedge_burst: float = 8.0,
                 clock: Callable[[], float] = _clock.monotonic) -> None:
        self._lock = threading.Lock()
        self._nodes: dict[tuple[str, str], _Node] = {}
        self._clock = clock
        self.hedge_ms = max(float(hedge_ms), 0.0)
        self._hedge_ratio = hedge_ratio
        self._hedge_burst = hedge_burst
        # the bucket starts FULL: a cold cluster's first read may have
        # several parts stalling on the same slow node at once, and
        # each deserves a hedge before any budget has accrued.
        # Sustained amplification still converges to hedge_ratio
        # because accrual is per-primary and capped at the burst.
        self._hedge_tokens = hedge_burst
        self._samples: deque[float] = deque(maxlen=self.SAMPLE_WINDOW)
        self._p95: Optional[float] = None  # memoized; None = recompute
        #: optional QoS hedge gate (cluster/qos.py allow_hedge):
        #: consulted before any token is consumed, so a suppressed
        #: launch never burns budget.  None = no gate (pre-QoS
        #: behavior).  The callable must be thread-safe to READ (the
        #: scheduler's is: counter reads + a ring scan).
        self._hedge_gate: Optional[Callable[[], bool]] = None
        self.hedges_fired = 0
        self.hedges_won = 0
        self.hedges_cancelled = 0
        self.primaries = 0
        # weakly self-register with the process metrics registry: the
        # scoreboard is already thread-safe, so a /metrics scrape just
        # takes an extra stats() snapshot
        from chunky_bits_tpu_torch.obs.metrics import get_registry

        get_registry().register_source("health", self)

    @property
    def hedge_ratio(self) -> float:
        """Budget accrued per primary fetch — the amplification
        bound's slope.  Public so external assertions (the simulator's
        hedge-budget verdict) read the SAME numbers the accrual uses:
        fired <= ratio * primaries + burst."""
        return self._hedge_ratio

    @property
    def hedge_burst(self) -> float:
        """Token ceiling (and starting balance) — the amplification
        bound's intercept."""
        return self._hedge_burst

    # ---- recording (the location.py instrument hooks call these) ----

    def _node(self, location) -> _Node:
        key = location_key(location)
        node = self._nodes.get(key)
        if node is None:
            node = self._nodes[key] = _Node()
        return node

    def begin(self, location) -> None:
        """An I/O against ``location`` started (in-flight count)."""
        with self._lock:
            self._node(location).inflight += 1

    def finish(self, location, ok: Optional[bool],
               seconds: Optional[float]) -> None:
        """Paired with :meth:`begin`: the I/O completed.  ``ok=None``
        closes the in-flight count without a verdict — a cancelled
        hedge loser says nothing about the node's health."""
        with self._lock:
            node = self._node(location)
            node.inflight = max(node.inflight - 1, 0)
            if ok is not None:
                self._record_locked(node, ok, seconds)

    def record(self, location, ok: bool,
               seconds: Optional[float] = None) -> None:
        """An unpaired completion (streaming opens, mapper hits, or a
        corruption verdict with ``seconds=None``)."""
        with self._lock:
            self._record_locked(self._node(location), ok, seconds)

    def record_latency_floor(self, location, seconds: float) -> None:
        """A lower-bound latency observation WITHOUT a verdict: a
        cancelled hedge loser ran at least this long before losing.
        Feeds the EWMA and the p95 pool (so ordering learns the
        straggler and the hedge delay adapts) but leaves error rate,
        consecutive-failure count and breaker state untouched — losing
        a race is not a success, and must not close an open breaker."""
        with self._lock:
            node = self._node(location)
            a = self.ALPHA
            node.ewma = (seconds if node.ewma is None
                         else node.ewma + a * (seconds - node.ewma))
            self._samples.append(seconds)
            self._p95 = None

    def _record_locked(self, node: _Node, ok: bool,
                       seconds: Optional[float]) -> None:
        node.reads += 1
        a = self.ALPHA
        node.err += a * ((0.0 if ok else 1.0) - node.err)
        if ok:
            node.consec_failures = 0
            if node.breaker != CLOSED:
                node.breaker = CLOSED
            if seconds is not None:
                node.ewma = (seconds if node.ewma is None
                             else node.ewma + a * (seconds - node.ewma))
                self._samples.append(seconds)
                self._p95 = None
        else:
            node.errors += 1
            node.consec_failures += 1
            if (node.breaker == HALF_OPEN
                    or node.consec_failures >= self.BREAKER_FAILURES):
                node.breaker = OPEN
                node.opened_at = self._clock()

    # ---- breaker / scoring ----

    def _state_locked(self, node: _Node) -> str:
        if node.breaker == OPEN and (self._clock() - node.opened_at
                                     >= self.BREAKER_COOLDOWN):
            # cooldown elapsed: the next attempt is the half-open probe
            node.breaker = HALF_OPEN
        return node.breaker

    def breaker_state(self, location) -> str:
        with self._lock:
            return self._state_locked(self._node(location))

    def degraded(self, location) -> bool:
        """True when placement should prefer other nodes: breaker not
        closed, or error rate above the degraded threshold."""
        with self._lock:
            node = self._nodes.get(location_key(location))
            if node is None:
                return False
            return (self._state_locked(node) != CLOSED
                    or node.err > self.DEGRADED_ERR)

    def degraded_keys(self) -> frozenset:
        """The ``location_key`` of every currently-degraded node, as
        one set — the scrub priority pre-scan intersects a meta-log
        index's per-ref node keys against this instead of calling
        :meth:`degraded` once per replica of every ref in the
        namespace.  Same predicate as :meth:`degraded`; the set is
        small (nodes, not objects) and a point-in-time snapshot like
        any single ``degraded`` call."""
        with self._lock:
            return frozenset(
                key for key, node in self._nodes.items()
                if (self._state_locked(node) != CLOSED
                    or node.err > self.DEGRADED_ERR))

    def order(self, locations: Sequence) -> list:
        """``locations`` sorted best-health-first: closed breakers
        before half-open before open, lower error rate, lower EWMA
        latency, fewer in-flight.  The sort is stable, so locations the
        scoreboard knows nothing about keep their metadata order — a
        fresh scoreboard reproduces the reference's walk exactly."""
        penalty = {CLOSED: 0, HALF_OPEN: 1, OPEN: 2}

        def score(location) -> tuple:
            with self._lock:
                node = self._nodes.get(location_key(location))
                if node is None:
                    return (0, 0.0, 0.0, 0)
                return (penalty[self._state_locked(node)],
                        round(node.err, 2),
                        node.ewma or 0.0,
                        node.inflight)

        return sorted(locations, key=score)

    # ---- hedge machinery ----

    @property
    def hedge_enabled(self) -> bool:
        return self.hedge_ms > 0.0

    def note_primary(self) -> None:
        """A primary (non-hedge) fetch started: accrue hedge budget."""
        with self._lock:
            self.primaries += 1
            self._hedge_tokens = min(
                self._hedge_tokens + self._hedge_ratio,
                self._hedge_burst)

    def set_hedge_gate(
            self, fn: Optional[Callable[[], bool]]) -> None:
        """Install (or clear) the QoS hedge gate: a callable the
        scheduler owns that returns False when speculative load should
        yield (admission pressure, or ample p99 headroom worth
        conserving budget for).  Gate-denied launches consume NO
        token — suppression must never tax the budget it protects."""
        with self._lock:
            self._hedge_gate = fn

    def hedge_allowed(self) -> bool:
        """Cheap gate pre-check (no token movement): lets the read
        path skip arming a hedge timeout it would be denied anyway
        (file/file_part.py).  True when no gate is installed."""
        gate = self._hedge_gate
        return gate is None or gate()

    def try_fire_hedge(self) -> bool:
        """Consume one hedge token if available AND the QoS gate (when
        installed) allows.  False = budget exhausted or suppressed,
        the caller keeps waiting on its primary."""
        gate = self._hedge_gate
        if gate is not None and not gate():
            return False
        with self._lock:
            if self._hedge_tokens < 1.0:
                return False
            self._hedge_tokens -= 1.0
            self.hedges_fired += 1
            return True

    def hedge_won(self) -> None:
        with self._lock:
            self.hedges_won += 1

    def hedge_cancelled(self, n: int = 1) -> None:
        with self._lock:
            self.hedges_cancelled += n

    def hedge_delay(self) -> float:
        """Adaptive hedge delay in SECONDS: the p95 of recent success
        latencies, clamped to ``[hedge_ms, CEILING_FACTOR*hedge_ms]``.
        With no samples yet the floor applies — hedging a cold cluster
        after ``hedge_ms`` is the configured intent."""
        floor = self.hedge_ms / 1000.0
        with self._lock:
            if self._p95 is None and self._samples:
                ordered = sorted(self._samples)
                self._p95 = ordered[min(int(len(ordered) * 0.95),
                                        len(ordered) - 1)]
            p95 = self._p95
        if p95 is None:
            return floor
        return min(max(p95, floor), floor * self.CEILING_FACTOR)

    # ---- reporting ----

    def stats(self) -> HealthStats:
        with self._lock:
            rows = []
            for key in sorted(self._nodes):
                node = self._nodes[key]
                rows.append(LocationHealth(
                    key=key,
                    ewma_ms=(None if node.ewma is None
                             else node.ewma * 1000.0),
                    err_rate=node.err,
                    inflight=node.inflight,
                    breaker=self._state_locked(node),
                    completions=node.reads,
                    errors=node.errors,
                ))
            return HealthStats(
                locations=rows,
                hedges_fired=self.hedges_fired,
                hedges_won=self.hedges_won,
                hedges_cancelled=self.hedges_cancelled,
                primaries=self.primaries,
            )
