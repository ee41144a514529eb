"""SLO engine: windowed burn-rate alerting over the metrics registry (the
port of ``chunky_bits_tpu/obs/slo.py``).

The registry (``obs/metrics.py``) is cumulative: it answers "what happened
since process start", never "is the SLO burning now".  This module is the
windowed evaluation layer on top: a bounded ring of clock-seam-timestamped
registry snapshots with delta / ratio / quantile-over-window views of the
cumulative counters and histograms, and a closed declarative rule set
(:data:`RULES`) evaluated as multi-window burn rates (a fast and a slow
window must both breach) through a ``pending -> firing -> resolved`` alert
state machine with hold-down hysteresis and a bounded firing-history ring.

**One set of numbers everywhere.**  The engine reads the same snapshots
``/metrics`` renders and publishes its own state back into the registry as
``cb_slo_value``, ``cb_alerts_state``, ``cb_alerts_transitions_total`` and
``cb_slo_evaluations_total`` (closed ``rule`` label set), so the gateway's
``GET /alerts``, the ``slo`` stanza of ``/stats`` and ``chunky-bits
stats``, the ``Slo<...>`` profiler stanza and a Prometheus scrape all
derive from the one evaluation.  Under a multi-worker supervisor the
``cb_alerts_state`` gauges ride the snapshot spool like every other
family, and :func:`fleet_alert_states` merges the fleet view (firing on
any worker means firing fleet-wide; a spool-reaped dead worker drops out).

**Counter resets are epochs, not negative rates.**  A worker restart
resets its cumulative counters; every windowed delta here is computed per
label set and clamps a negative delta to the end value (Prometheus
``increase`` semantics), so a restart reads as a small positive delta.

**Time goes through the clock seam** (``utils/clock.py``): snapshot
timestamps, window arithmetic and the pending/clear hold-downs all read
``clock.monotonic()``, so the same engine runs in compressed virtual time
under ``sim.run``.

Off by default: nothing constructs an engine until a gateway
(``tunables.slo_eval_s`` > 0) asks for one, and the serve and encode paths
never touch it; the only cost of a running engine is its periodic
``registry.snapshot()`` tick.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, fields
from typing import Callable, Optional, Sequence

from chunky_bits_tpu_torch.obs import metrics as obs_metrics

#: the clock seam (utils-side import, as file/profiler.py): window
#: arithmetic must follow the active clock, or the engine would read real
#: time inside a virtual-time simulation
from chunky_bits_tpu_torch.utils import clock as _clock

__all__ = [
    "ALERT_STATES",
    "RULES",
    "AlertStatus",
    "SloEngine",
    "SloObjectives",
    "SloStats",
    "SnapshotRing",
    "fleet_alert_states",
    "worker_labeled_snapshot",
]

#: the CLOSED rule set — also the closed value set of the ``rule``
#: metric label.  Adding a rule means adding it HERE, next to
#: its evaluator in SloEngine._evaluate; nothing mints rule names at
#: runtime.
RULES = (
    "availability",          # gateway 5xx ratio
    "read_latency_p99",      # gateway GET p99 vs objective
    "scrub_stall",           # scrub running but verifying nothing
    "repair_fallback_storm",  # planner escalating to classic resilver
    "breaker_open",          # fraction of nodes with tripped breakers
    "hedge_exhaustion",      # hedge fire rate at/above the budget slope
    "loop_lag_p99",          # event-loop scheduling delay p99
    "worker_down",           # live worker count below objective
)

#: alert states (ranked for the ``cb_alerts_state`` gauge: merging the
#: fleet view is a plain max)
INACTIVE = "inactive"
PENDING = "pending"
FIRING = "firing"
ALERT_STATES = (INACTIVE, PENDING, FIRING)
# lint: loop-shared-ok write-once module constants (state<->rank maps),
# read-only after import — no cross-loop mutation exists
_STATE_RANK = {INACTIVE: 0, PENDING: 1, FIRING: 2}
# lint: loop-shared-ok same write-once constant, inverted
_RANK_STATE = {rank: state for state, rank in _STATE_RANK.items()}

#: firing-history ring bound (engine-lifetime memory of resolved
#: alerts; the live states are unbounded-by-construction: one per rule)
MAX_HISTORY = 256

#: snapshot ring ENTRY-COUNT backstop.  The primary bound is by AGE
#: (the engine prunes entries older than its widest window + margin on
#: every append — a snapshot of a big fleet carries per-node families,
#: so retention must track what the rules can actually read back, not
#: a fixed count); this cap only catches a pathological tick cadence.
MAX_SNAPSHOTS = 512


@dataclass
class SloObjectives:
    """The operator-tunable objective knobs, one per rule (plus the
    shared window geometry).  YAML ``slo:`` mapping -> :meth:`from_obj`
    with loud unknown-key validation.  Defaults are deliberately
    conservative: alerting that cries wolf gets deleted."""

    #: shared multi-window geometry: breach must hold over BOTH the
    #: fast and the slow window (counters/ratios/quantiles), or persist
    #: for the fast window (instantaneous gauge rules)
    fast_s: float = 60.0
    slow_s: float = 300.0
    #: extra pending hold before firing (0 = fire on first two-window
    #: breach — the window pair is already the noise gate)
    for_s: float = 0.0
    #: hold-down hysteresis: a firing alert must observe clean windows
    #: this long before it resolves (flapping input, stable output)
    clear_s: float = 120.0
    #: availability: 5xx fraction of gateway requests
    availability_5xx_ratio: float = 0.01
    #: read latency: GET wall-time p99 objective, milliseconds
    read_p99_ms: float = 500.0
    #: scrub stall: scrub running but zero bytes verified for this long
    #: (must out-span the pass interval + a pass, or idle gaps alert)
    scrub_stall_s: float = 600.0
    #: repair fallback storm: this many classic-resilver escalations
    #: inside the fast window (the planner giving up is news)
    fallback_plans: float = 1.0
    #: breaker-open: fraction of traffic-bearing nodes whose breaker is
    #: not closed (open or half-open — both mean the node is degraded)
    breaker_node_fraction: float = 0.3
    #: hedge exhaustion: hedges fired per PRIMARY fetch at/above this.
    #: The scoreboard's budget slope (hedge_ratio) is 0.05, so a
    #: sustained fire rate there means the token bucket is pinned at
    #: its cap; the default sits at 90% of the slope because a pinned
    #: bucket burns at exactly the slope (give or take the burst) and
    #: an equality threshold would flap on float jitter
    hedge_fire_ratio: float = 0.045
    #: event-loop lag p99 objective, milliseconds
    loop_lag_p99_ms: float = 100.0
    #: minimum live gateway workers (0 disables the rule — a
    #: single-process deployment has nothing to compare against)
    min_workers: int = 0

    @classmethod
    def from_obj(cls, obj: object) -> "SloObjectives":
        if obj is None:
            return cls()
        if not isinstance(obj, dict):
            raise ValueError("slo objectives must be a mapping")
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(obj) - known)
        if unknown:
            raise ValueError(
                f"unknown slo objective(s) {unknown} "
                f"(know {sorted(known)})")
        kwargs = {}
        for key, value in obj.items():
            try:
                kwargs[key] = (int(value) if key == "min_workers"
                               else float(value))
            except (TypeError, ValueError) as err:
                raise ValueError(
                    f"invalid slo objective {key}={value!r}") from err
            if kwargs[key] < 0:
                raise ValueError(
                    f"slo objective {key} must be >= 0, got {value!r}")
        return cls(**kwargs)

    def to_obj(self) -> dict:
        return {f.name: getattr(self, f.name) for f in fields(self)}


class SnapshotRing:
    """Bounded ring of ``(t, snapshot)`` registry snapshots with the
    windowed delta/ratio/quantile views the rules read.

    Timestamps come off the clock seam unless the caller supplies
    ``now`` explicitly (tests and the simulator's deterministic ticks).
    All reads are per-label-set reset-aware: a cumulative series that
    went DOWN restarted (worker restart, spool-reaped sibling), and its
    delta is the post-reset end value, never negative."""

    def __init__(self, maxlen: int = MAX_SNAPSHOTS,
                 max_age_s: Optional[float] = None) -> None:
        self._entries: deque[tuple[float, dict]] = deque(maxlen=maxlen)
        #: age bound: entries older than this behind the newest are
        #: pruned on append (None = count-bound only).  The engine
        #: passes its widest window + margin — windowed reads never
        #: look further back, so keeping more would be pure memory.
        self.max_age_s = max_age_s

    def __len__(self) -> int:
        return len(self._entries)

    def append(self, snapshot: dict,
               now: Optional[float] = None) -> None:
        t = _clock.monotonic() if now is None else float(now)
        self._entries.append((t, snapshot))
        if self.max_age_s is not None:
            cutoff = t - self.max_age_s
            # keep >= 2 entries so delta views always have a pair
            while (len(self._entries) > 2
                   and self._entries[0][0] < cutoff
                   and self._entries[1][0] <= cutoff):
                self._entries.popleft()

    def latest(self) -> Optional[tuple[float, dict]]:
        return self._entries[-1] if self._entries else None

    # ---- window selection ----

    def _window_pair(self, window_s: float
                     ) -> Optional[tuple[tuple[float, dict],
                                         tuple[float, dict]]]:
        """(oldest-in-window entry, newest entry), or None when the
        ring does not yet span at least half the window — a young ring
        must read as "insufficient data", never as a zero rate."""
        if len(self._entries) < 2:
            return None
        newest = self._entries[-1]
        cutoff = newest[0] - window_s
        oldest = None
        for entry in self._entries:
            if entry[0] >= cutoff:
                oldest = entry
                break
        if oldest is None or oldest is newest:
            oldest = self._entries[-2]
        if newest[0] - oldest[0] < window_s * 0.5:
            return None
        return oldest, newest

    def window_entries(self, window_s: float
                       ) -> list[tuple[float, dict]]:
        """Every ring entry inside the trailing window (for gauge
        persistence checks)."""
        if not self._entries:
            return []
        cutoff = self._entries[-1][0] - window_s
        return [e for e in self._entries if e[0] >= cutoff]

    # ---- windowed views ----

    #: family-by-name lookup (shared with the stats CLI renderer)
    _family = staticmethod(obs_metrics.find_family)

    @staticmethod
    def _matches(labels: dict, match: Optional[dict]) -> bool:
        if not match:
            return True
        return all(labels.get(k) == v for k, v in match.items())

    def counter_delta(self, name: str, window_s: float,
                      match: Optional[dict] = None) -> Optional[float]:
        """Sum of per-series increases of a counter family over the
        trailing window; None when the family is absent from the newest
        snapshot or the ring is too young.  Per-series reset clamp: a
        negative per-key delta reads as the end value (fresh epoch)."""
        pair = self._window_pair(window_s)
        if pair is None:
            return None
        (_, old_snap), (_, new_snap) = pair
        new_fam = self._family(new_snap, name)
        if new_fam is None:
            return None
        old_fam = self._family(old_snap, name) or {"samples": []}
        old_vals = {
            tuple(sorted(s["labels"].items())): float(s.get("value", 0))
            for s in old_fam.get("samples", ())
        }
        total = 0.0
        for s in new_fam.get("samples", ()):
            if not self._matches(s["labels"], match):
                continue
            end = float(s.get("value", 0))
            start = old_vals.get(tuple(sorted(s["labels"].items())), 0.0)
            delta = end - start
            total += end if delta < 0 else delta
        return total

    def hist_window(self, name: str, window_s: float,
                    match: Optional[dict] = None
                    ) -> Optional[tuple[list, list]]:
        """(bucket bounds, per-bucket count increases) of a histogram
        family over the trailing window, summed across matching label
        sets; None when absent or too young.  The reset clamp is
        per-series, whole-vector: any bucket going backwards means the
        series restarted, so its window contribution is the end
        vector."""
        pair = self._window_pair(window_s)
        if pair is None:
            return None
        (_, old_snap), (_, new_snap) = pair
        new_fam = self._family(new_snap, name)
        if new_fam is None or "buckets" not in new_fam:
            return None
        bounds = list(new_fam["buckets"])
        old_fam = self._family(old_snap, name) or {"samples": []}
        old_counts = {
            tuple(sorted(s["labels"].items())): list(s.get("counts", ()))
            for s in old_fam.get("samples", ())
        }
        total = [0.0] * (len(bounds) + 1)
        for s in new_fam.get("samples", ()):
            if not self._matches(s["labels"], match):
                continue
            end = list(s.get("counts", ()))
            if len(end) != len(total):
                continue  # bucket layout changed: skip the series
            start = old_counts.get(tuple(sorted(s["labels"].items())))
            if start is None or len(start) != len(end) \
                    or any(e < o for e, o in zip(end, start)):
                delta = end  # fresh epoch
            else:
                delta = [e - o for e, o in zip(end, start)]
            for i, d in enumerate(delta):
                total[i] += d
        return bounds, total

    def quantile(self, name: str, q: float, window_s: float,
                 match: Optional[dict] = None) -> Optional[float]:
        """``histogram_quantile`` over the window's bucket increases;
        None when absent/young/empty-in-window."""
        win = self.hist_window(name, window_s, match)
        if win is None:
            return None
        bounds, counts = win
        if sum(counts) <= 0:
            return None
        return obs_metrics.histogram_quantile(bounds, counts, q)

    def gauge_values(self, snapshot: dict, name: str,
                     match: Optional[dict] = None
                     ) -> Optional[list[float]]:
        """All matching sample values of a gauge family in one
        snapshot; None when the family is absent."""
        fam = self._family(snapshot, name)
        if fam is None:
            return None
        return [float(s.get("value", 0))
                for s in fam.get("samples", ())
                if self._matches(s["labels"], match)]

    def gauge_persisted(self, window_s: float,
                        reduce_fn: Callable[[dict], Optional[float]]
                        ) -> Optional[float]:
        """Minimum of ``reduce_fn(snapshot)`` over the trailing window
        — the persistence view of an instantaneous gauge rule: only a
        value that held for (at least half) the window counts.  None
        when the ring is young or any reduction is None."""
        entries = self.window_entries(window_s)
        if len(entries) < 2 \
                or entries[-1][0] - entries[0][0] < window_s * 0.5:
            return None
        values = []
        for _t, snap in entries:
            v = reduce_fn(snap)
            if v is None:
                return None
            values.append(v)
        return min(values)


@dataclass
class AlertStatus:
    """One rule's live state — the ``/alerts`` row."""

    rule: str
    state: str = INACTIVE
    since: float = 0.0            # when the current state was entered
    value_fast: Optional[float] = None
    value_slow: Optional[float] = None
    threshold: float = 0.0
    fired_count: int = 0          # lifetime firings of this rule
    _pending_since: Optional[float] = None
    _clear_since: Optional[float] = None

    def to_obj(self) -> dict:
        return {
            "rule": self.rule,
            "state": self.state,
            "since": round(self.since, 3),
            "value_fast": (None if self.value_fast is None
                           else round(self.value_fast, 6)),
            "value_slow": (None if self.value_slow is None
                           else round(self.value_slow, 6)),
            "threshold": self.threshold,
            "fired_count": self.fired_count,
        }


@dataclass
class SloStats:
    """Engine snapshot for the ``Slo<...>`` profiler stanza and the
    ``/stats`` payload."""

    evaluations: int
    firing: list[str]
    pending: list[str]
    resolved_total: int

    def to_obj(self) -> dict:
        return {
            "evaluations": self.evaluations,
            "firing": list(self.firing),
            "pending": list(self.pending),
            "resolved_total": self.resolved_total,
        }

    def __str__(self) -> str:
        firing = ",".join(self.firing) or "-"
        pending = ",".join(self.pending) or "-"
        return (f"Slo<evals={self.evaluations} firing=[{firing}] "
                f"pending=[{pending}] "
                f"resolved={self.resolved_total}>")


class SloEngine:
    """The windowed evaluator: feed it snapshots, read alert states.

    ``observe()`` is the one write path — append a snapshot to the
    ring, evaluate every rule's fast/slow window pair, step each
    rule's state machine, and publish ``cb_slo_*`` / ``cb_alerts_*``
    into ``registry``.  Thread-safe the registry way (one lock, sync
    updates only) because the gateway ticker and a ``/alerts`` handler
    may interleave; in the simulator everything runs on one loop and
    the lock is uncontended.

    ``on_transition(rule, old_state, new_state, t, value)`` fires on
    every state change: a trace hook, which makes detection latency a
    deterministic, assertable number under ``sim.run``.
    """

    def __init__(self, objectives: Optional[SloObjectives] = None,
                 registry: Optional[obs_metrics.MetricsRegistry] = None,
                 on_transition: Optional[Callable] = None) -> None:
        self.objectives = objectives or SloObjectives()
        self._registry = registry or obs_metrics.get_registry()
        self._on_transition = on_transition
        self._lock = threading.Lock()
        # retain exactly what the rules can read back: the widest
        # configured window, doubled for the window-pair selection's
        # slack, plus a couple of minutes of margin
        obj = self.objectives
        widest = max(obj.fast_s, obj.slow_s, obj.scrub_stall_s)
        self.ring = SnapshotRing(max_age_s=widest * 2.0 + 120.0)
        self._alerts = {rule: AlertStatus(rule=rule) for rule in RULES}
        self._history: deque[dict] = deque(maxlen=MAX_HISTORY)
        self._evaluations = 0
        self._resolved_total = 0
        # the engine's own families (closed `rule` label set = RULES):
        # published into the registry so they ride the fleet
        # spool like every other series
        self._g_value = self._registry.gauge(
            "cb_slo_value",
            "latest fast-window value per SLO rule", labels=("rule",))
        self._g_state = self._registry.gauge(
            "cb_alerts_state",
            "alert state per rule (0 inactive, 1 pending, 2 firing)",
            labels=("rule",))
        self._c_transitions = self._registry.counter(
            "cb_alerts_transitions_total",
            "alert state-machine transitions", labels=("rule", "to"))
        self._c_evals = self._registry.counter(
            "cb_slo_evaluations_total", "SLO engine evaluations")
        for rule in RULES:
            self._g_state.labels(rule=rule).set(0)

    # ---- rule evaluation (value extraction) ----

    def _ratio(self, name: str, window_s: float, num_match: dict,
               den_match: Optional[dict] = None) -> Optional[float]:
        num = self.ring.counter_delta(name, window_s, num_match)
        den = self.ring.counter_delta(name, window_s, den_match)
        if num is None or den is None or den <= 0:
            return None
        return num / den

    def _breaker_fraction(self, snapshot: dict) -> Optional[float]:
        values = self.ring.gauge_values(snapshot,
                                        "cb_node_breaker_state")
        if not values:
            return None  # no traffic-bearing nodes yet
        return sum(1 for v in values if v >= 1) / len(values)

    def _workers_missing(self, snapshot: dict) -> Optional[float]:
        if self.objectives.min_workers <= 0:
            return None
        values = self.ring.gauge_values(snapshot, "cb_worker_up")
        if values is None:
            return None  # not a gateway process
        return float(self.objectives.min_workers) - sum(values)

    def _hedge_rate(self, window_s: float) -> Optional[float]:
        """Hedges fired per primary fetch over the window — the exact
        slope of the scoreboard's budget bound (fired <= ratio *
        primaries + burst), so a sustained value at/near the ratio
        means the token bucket is pinned at its cap."""
        fired = self.ring.counter_delta("cb_hedges_fired_total",
                                        window_s)
        if fired is None:
            return None
        prim = self.ring.counter_delta("cb_hedge_primaries_total",
                                       window_s)
        return fired / max(prim or 0.0, 1.0)

    def _scrub_stalled(self, window_s: float) -> Optional[float]:
        latest = self.ring.latest()
        if latest is None:
            return None
        running = self.ring.gauge_values(latest[1], "cb_scrub_running")
        if not running or sum(running) <= 0:
            return 0.0 if running is not None else None
        verified = self.ring.counter_delta(
            "cb_scrub_bytes_verified_total", window_s)
        if verified is None:
            return None
        return 1.0 if verified <= 0 else 0.0

    def _evaluate(self) -> dict[str, tuple[Optional[float],
                                           Optional[float], float]]:
        """(fast value, slow value, threshold) per rule.  None means
        "insufficient data": never a breach, and clears a firing alert
        (no data is no evidence of burn)."""
        obj = self.objectives
        fast, slow = obj.fast_s, obj.slow_s
        latest = self.ring.latest()
        latest_snap = latest[1] if latest else {"families": []}
        out: dict = {}
        out["availability"] = (
            self._ratio("cb_request_total", fast,
                        {"status_class": "5xx"}),
            self._ratio("cb_request_total", slow,
                        {"status_class": "5xx"}),
            obj.availability_5xx_ratio)
        q_fast = self.ring.quantile("cb_request_seconds", 99.0, fast,
                                    {"method": "GET"})
        q_slow = self.ring.quantile("cb_request_seconds", 99.0, slow,
                                    {"method": "GET"})
        out["read_latency_p99"] = (
            None if q_fast is None else q_fast * 1000.0,
            None if q_slow is None else q_slow * 1000.0,
            obj.read_p99_ms)
        stall = self._scrub_stalled(obj.scrub_stall_s)
        out["scrub_stall"] = (stall, stall, 1.0)
        out["repair_fallback_storm"] = (
            self.ring.counter_delta("cb_repair_plans_total", fast,
                                    {"kind": "fallback"}),
            self.ring.counter_delta("cb_repair_plans_total", slow,
                                    {"kind": "fallback"}),
            obj.fallback_plans)
        out["breaker_open"] = (
            self._breaker_fraction(latest_snap),
            self.ring.gauge_persisted(fast, self._breaker_fraction),
            obj.breaker_node_fraction)
        out["hedge_exhaustion"] = (
            self._hedge_rate(fast), self._hedge_rate(slow),
            obj.hedge_fire_ratio)
        lag_fast = self.ring.quantile("cb_eventloop_lag_seconds", 99.0,
                                      fast)
        lag_slow = self.ring.quantile("cb_eventloop_lag_seconds", 99.0,
                                      slow)
        out["loop_lag_p99"] = (
            None if lag_fast is None else lag_fast * 1000.0,
            None if lag_slow is None else lag_slow * 1000.0,
            obj.loop_lag_p99_ms)
        out["worker_down"] = (
            self._workers_missing(latest_snap),
            self.ring.gauge_persisted(fast, self._workers_missing),
            1.0)
        return out

    # ---- the state machine ----

    def _transition(self, alert: AlertStatus, new_state: str,
                    now: float) -> None:
        old = alert.state
        alert.state = new_state
        alert.since = now
        self._c_transitions.labels(rule=alert.rule, to=new_state).inc()
        if new_state == FIRING:
            alert.fired_count += 1
            self._history.append({"rule": alert.rule, "fired_at": now,
                                  "resolved_at": None,
                                  "value": alert.value_fast})
        elif old == FIRING:
            self._resolved_total += 1
            for entry in reversed(self._history):
                if entry["rule"] == alert.rule \
                        and entry["resolved_at"] is None:
                    entry["resolved_at"] = now
                    break
        if self._on_transition is not None:
            self._on_transition(alert.rule, old, new_state, now,
                                alert.value_fast)

    def _step(self, alert: AlertStatus, now: float,
              v_fast: Optional[float], v_slow: Optional[float],
              threshold: float) -> None:
        alert.value_fast = v_fast
        alert.value_slow = v_slow
        alert.threshold = threshold
        breach = (v_fast is not None and v_slow is not None
                  and v_fast >= threshold and v_slow >= threshold)
        obj = self.objectives
        if alert.state == INACTIVE:
            if breach:
                alert._pending_since = now
                if obj.for_s <= 0:
                    self._transition(alert, FIRING, now)
                else:
                    self._transition(alert, PENDING, now)
        elif alert.state == PENDING:
            if not breach:
                alert._pending_since = None
                self._transition(alert, INACTIVE, now)
            elif now - (alert._pending_since or now) >= obj.for_s:
                self._transition(alert, FIRING, now)
        else:  # FIRING
            if breach:
                alert._clear_since = None
                return
            # hysteresis hold-down: clean (or data-less) windows must
            # persist clear_s before the alert resolves
            if alert._clear_since is None:
                alert._clear_since = now
            if now - alert._clear_since >= obj.clear_s:
                alert._clear_since = None
                alert._pending_since = None
                self._transition(alert, INACTIVE, now)

    # ---- public surface ----

    def observe(self, snapshot: Optional[dict] = None,
                now: Optional[float] = None) -> None:
        """One evaluation tick: append ``snapshot`` (default: this
        registry's own) to the ring, evaluate every rule, step the
        state machines, publish the ``cb_slo_*`` families."""
        if snapshot is None:
            snapshot = self._registry.snapshot()
        t = _clock.monotonic() if now is None else float(now)
        with self._lock:
            self.ring.append(snapshot, now=t)
            values = self._evaluate()
            for rule in RULES:
                v_fast, v_slow, threshold = values[rule]
                self._step(self._alerts[rule], t, v_fast, v_slow,
                           threshold)
                if v_fast is not None:
                    self._g_value.labels(rule=rule).set(v_fast)
                self._g_state.labels(rule=rule).set(
                    _STATE_RANK[self._alerts[rule].state])
            self._evaluations += 1
            self._c_evals.inc()

    def alerts(self) -> list[AlertStatus]:
        with self._lock:
            return [self._alerts[rule] for rule in RULES]

    def firing(self) -> list[str]:
        with self._lock:
            return [r for r in RULES
                    if self._alerts[r].state == FIRING]

    def history(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._history]

    def stats(self) -> SloStats:
        with self._lock:
            return SloStats(
                evaluations=self._evaluations,
                firing=[r for r in RULES
                        if self._alerts[r].state == FIRING],
                pending=[r for r in RULES
                         if self._alerts[r].state == PENDING],
                resolved_total=self._resolved_total,
            )

    def to_obj(self) -> dict:
        """The ``/alerts`` payload body (single-process form; the
        gateway handler adds the fleet merge under a supervisor)."""
        with self._lock:
            return {
                "enabled": True,
                "evaluations": self._evaluations,
                "alerts": [self._alerts[rule].to_obj()
                           for rule in RULES],
                "firing": [r for r in RULES
                           if self._alerts[r].state == FIRING],
                "history": [
                    {**e,
                     "fired_at": round(e["fired_at"], 3),
                     "resolved_at": (None if e["resolved_at"] is None
                                     else round(e["resolved_at"], 3)),
                     "value": (None if e["value"] is None
                               else round(e["value"], 6))}
                    for e in self._history],
                "objectives": self.objectives.to_obj(),
            }


def worker_labeled_snapshot(entries: Sequence[tuple[Optional[str],
                                                   dict]]) -> dict:
    """Combine per-worker registry snapshots for the ENGINE's ring:
    every sample of every kind gains a ``worker`` label instead of
    being summed (``merge_snapshots`` sums counters across workers,
    which would make the ring's per-series reset clamp misfire — one
    worker restarting drops the fleet SUM slightly, and a negative
    delta on a summed series would clamp to the surviving workers'
    entire lifetime total, firing every ratio rule spuriously).  With
    worker-labeled series the deltas are per worker: a restarted
    worker clamps only its own small post-reset value, and a
    spool-reaped worker's series simply vanish from the newest
    snapshot and contribute nothing.  Window sums/ratios over the
    labeled series equal the fleet numbers, because the rules sum
    matching samples anyway."""
    fams: dict[str, dict] = {}
    for worker_id, snap in entries:
        wid = str(worker_id)
        for fam in snap.get("families", ()):
            out = fams.get(fam["name"])
            if out is None:
                out = fams[fam["name"]] = {
                    "name": fam["name"], "type": fam["type"],
                    "help": fam.get("help", ""), "samples": []}
                if "buckets" in fam:
                    out["buckets"] = list(fam["buckets"])
            for s in fam.get("samples", ()):
                labeled = dict(s)
                labeled["labels"] = {**s.get("labels", {}),
                                     "worker": wid}
                out["samples"].append(labeled)
    return {"families": [fams[name] for name in sorted(fams)]}


# ---- fleet aggregation (the /alerts twin of merge_snapshots) ----


def fleet_alert_states(entries: Sequence[tuple[Optional[str], dict]]
                       ) -> dict:
    """Merge per-worker registry snapshots' ``cb_alerts_state`` gauges
    into the fleet alert view: per rule, the MAX state across workers
    (firing on any worker means the fleet is firing), plus the
    per-worker breakdown so an operator sees WHICH worker burns.
    ``entries`` is ``[(worker_id, snapshot)]`` — the same spool shape
    :func:`obs.metrics.load_spool` returns, so a spool-reaped dead
    worker simply is not in the input and cannot contribute a stale
    firing alert."""
    per_worker: dict[str, dict[str, str]] = {}
    fleet: dict[str, str] = {rule: INACTIVE for rule in RULES}
    for worker_id, snap in entries:
        states: dict[str, str] = {}
        for fam in snap.get("families", ()):
            if fam.get("name") != "cb_alerts_state":
                continue
            for s in fam.get("samples", ()):
                rule = s.get("labels", {}).get("rule")
                if rule not in fleet:
                    continue  # closed set: foreign labels are ignored
                state = _RANK_STATE.get(int(s.get("value", 0)),
                                        INACTIVE)
                states[rule] = state
                if _STATE_RANK[state] > _STATE_RANK[fleet[rule]]:
                    fleet[rule] = state
        if states:
            per_worker[str(worker_id)] = states
    return {
        "fleet": fleet,
        "firing": [r for r in RULES if fleet[r] == FIRING],
        "workers": dict(sorted(per_worker.items())),
    }
