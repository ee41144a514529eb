"""The scenario engine (the port of ``chunky_bits_tpu/sim/scenario.py``):
scripted fleet-scale fault timelines with convergence invariants and a
seed-reproducible event trace.

A scenario is a coroutine driving a :class:`ScenarioEnv` — a simulated
cluster (``sim/fabric.py`` nodes behind real ``Cluster`` machinery)
running on the virtual-time loop (``sim/loop.py``), with a fresh
metrics registry as the observer.  The engine provides the shared
plumbing every scenario needs:

* a **generated namespace** (seeded payloads, real erasure-coded
  writes through the production writer/placement path, zone-capped by
  ``zone_rules`` so any single-AZ loss stays within parity);
* a **background client** (sequential seeded reads asserting byte
  identity, failures timestamped against the scripted fault windows);
* the **scrub/repair plane** (the production ``ScrubDaemon`` +
  ``RepairPlanner``, byte-metered in virtual time);
* **invariant verdicts** — namespace returns to Valid, no
  client-visible error outside a fault window, hedge amplification
  within the token-bucket budget, repair bytes within the config-11/13
  structural bounds (copy ≤ 1x, decode = d x, msr = 2x — exact
  per-plan accounting, never estimates);
* **SLO detection verdicts** — every scenario runs the production SLO
  engine (obs/slo.py) over its fresh registry, ticked in virtual time;
  the scenario's ``slo`` spec names which alerts MUST fire (within a
  bounded virtual-time detection latency of the scripted fault, and
  resolve after convergence) and the engine must stay silent otherwise
  (zero firing onsets outside fault windows + grace — deterministic
  precision AND recall for the whole alerting stack, something a real
  cluster can never prove).  Alert transitions are trace events, so
  detection latency is part of the byte-identical determinism pin;
* the **event trace** — every fabric state transition, scripted
  action, client error and verdict as one canonical JSON line with its
  virtual timestamp.  Same seed ⇒ byte-identical trace and equal
  metrics snapshot (tests/test_torch_sim.py pins it; the virtual loop's
  serialized thread plane and the fabric's per-node seeded RNGs are
  what make it true).

``SCENARIOS`` is the library (BASELINE config 14; ``chip_smoke.py``'s
``simulator`` group runs it on the card): AZ outage mid-scrub, rolling
restart (plain and during pm-msr repair), thundering-herd reads,
correlated in-zone disk failures, flapping node, slow-leak corruption,
a disk-corruption storm, a noisy neighbour and a fleet partition.

Scenario clusters name no backend, so they run on the port's default
(``cuda``); payloads stay under the host pipeline's 128 KiB inline bound,
so every device wait goes through ``run_in_executor`` and virtual time
never jumps over it (``sim/loop.py``).
"""

from __future__ import annotations

import asyncio
import random
import shutil
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional

from chunky_bits_tpu_torch.obs import metrics as obs_metrics
from chunky_bits_tpu_torch.sim import fabric as fabric_mod
from chunky_bits_tpu_torch.sim import loop as sim_loop
from chunky_bits_tpu_torch.utils import clock as _clock

__all__ = [
    "SCENARIOS",
    "ScenarioEnv",
    "ScenarioResult",
    "run_scenario",
]


def _json_line(obj: dict) -> str:
    import json

    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


class EventTrace:
    """Ordered (virtual time, event, fields) records; canonical
    serialization is one sorted-key JSON line per event."""

    def __init__(self) -> None:
        self.events: list[tuple[float, str, dict]] = []

    def record(self, t: float, event: str, fields: dict) -> None:
        self.events.append((t, event, dict(fields)))

    def to_bytes(self) -> bytes:
        lines = [
            _json_line({"t": round(t, 6), "event": event, **fields})
            for t, event, fields in self.events
        ]
        return ("\n".join(lines) + "\n").encode("utf-8")


@dataclass
class ScenarioResult:
    """One scenario run's outcome: the config-14 row and the
    determinism test's comparison unit."""

    name: str
    seed: int
    nodes: int
    virtual_seconds: float
    wall_seconds: float
    trace: bytes
    metrics: dict
    verdicts: dict[str, bool]
    details: dict = field(default_factory=dict)

    def ok(self) -> bool:
        return all(self.verdicts.values()) and bool(self.verdicts)

    def compression(self) -> float:
        """Virtual seconds lived per wall second spent — the headline
        the simulator exists for."""
        if self.wall_seconds <= 0:
            return 0.0
        return self.virtual_seconds / self.wall_seconds

    def to_obj(self) -> dict:
        return {
            "name": self.name,
            "seed": self.seed,
            "nodes": self.nodes,
            "virtual_s": round(self.virtual_seconds, 3),
            "wall_s": round(self.wall_seconds, 3),
            "compression_x": round(self.compression(), 1),
            "ok": self.ok(),
            "verdicts": dict(sorted(self.verdicts.items())),
            "trace_events": self.trace.count(b"\n"),
            **self.details,
        }


class ScenarioEnv:
    """Shared scenario plumbing; see the module docstring.  Construct
    and drive only inside ``sim.run`` — every time-sensitive object it
    builds must be born under the virtual clock."""

    def __init__(self, name: str, workdir: str, *,
                 nodes: int = 100, seed: int = 0,
                 zones: tuple[str, ...] = ("az0", "az1", "az2"),
                 data: int = 3, parity: int = 2, chunk_log2: int = 12,
                 code: str = "rs",
                 objects: int = 24, object_bytes: int = 18_000,
                 hedge_ms: float = 0.0,
                 scrub_bytes_per_sec: float = 0.0,
                 scrub_interval_s: float = 60.0,
                 read_retries: int = 1) -> None:
        import os

        from chunky_bits_tpu_torch.cluster import Cluster

        self.name = name
        self.seed = seed
        self.trace = EventTrace()
        # the global-`random` consumers on the read/write paths (worker
        # pool draws, retry jitter) must replay identically run-to-run
        random.seed(seed * 2_654_435_761 + 97)
        self.rand = random.Random(seed + 1)
        self.fabric = fabric_mod.SimFabric(
            f"sc-{name}", nodes, zones=zones, seed=seed)
        self.fabric.trace_hook = self.trace.record
        self.d, self.p = data, parity
        self.chunk_bytes = 1 << chunk_log2
        meta = os.path.join(workdir, "meta")
        os.makedirs(meta, exist_ok=True)
        # zone cap = parity: any single-AZ loss leaves >= d chunks of
        # every part reachable, so reads survive the outage by
        # reconstruction — the placement rule a real deployment runs
        profile = {
            "data": data, "parity": parity, "chunk_size": chunk_log2,
            "code": code,
            "rules": {z: {"maximum": parity, "ideal": 1}
                      for z in zones},
        }
        self.cluster = Cluster.from_obj({
            "destinations": self.fabric.destination_objs(),
            "metadata": {"type": "path", "format": "yaml", "path": meta},
            "profiles": {"default": profile},
            "tunables": {
                **({"hedge_ms": hedge_ms} if hedge_ms > 0 else {}),
                "read_retries": read_retries,
                # always the process-shared host pipeline (YAML wins
                # over the CI matrix's HOST_THREADS env): a
                # cluster-pinned pipeline would register its
                # wall-clock busy/idle counters with THIS run's fresh
                # registry and break snapshot equality between runs
                "host_threads": 0,
            },
        })
        self.objects = objects
        self.object_bytes = object_bytes
        self.contents: dict[str, bytes] = {}
        self.scrub_interval_s = scrub_interval_s
        self.scrub_rate = scrub_bytes_per_sec
        self._daemon = None
        self._client_task: Optional[asyncio.Task] = None
        self._client_errors: list[tuple[float, str, str]] = []
        self.client_reads = 0
        self._fault_windows: list[list[float]] = []
        self._fault_begins: list[float] = []  # raw (non-backdated)
        self.verdicts: dict[str, bool] = {}
        # SLO engine plumbing (start_slo)
        self.slo_engine = None
        self.slo_spec: dict = {}
        self._slo_task: Optional[asyncio.Task] = None
        self._slo_tick_s = 15.0
        #: every alert state transition as (virtual t, rule, old, new)
        #: — the detection-verdict input, also traced
        self.alert_transitions: list[tuple[float, str, str, str]] = []

    # ---- tracing / verdicts ----

    def now(self) -> float:
        return _clock.monotonic()

    def event(self, event: str, **fields: object) -> None:
        self.trace.record(self.now(), event, fields)

    def verdict(self, name: str, ok: bool, **fields: object) -> None:
        self.verdicts[name] = bool(ok)
        self.event("verdict", verdict=name, ok=bool(ok), **fields)

    async def sleep(self, seconds: float) -> None:
        await _clock.sleep(seconds)

    # ---- fault windows (the reads-clean invariant's exclusions) ----

    def fault_begin(self, backdate_s: float = 30.0) -> None:
        """Open a fault window.  The begin edge is backdated by
        ``backdate_s``: a client read already in flight when the fault
        lands is timestamped at ITS start, and an error it takes from
        the freshly-injected fault belongs to the window, not to the
        healthy period before it (the end edge gets the symmetric
        treatment via ``fault_end``'s grace).  The RAW begin time is
        kept separately: it is the zero point SLO detection latency is
        measured from."""
        self._fault_begins.append(self.now())
        self._fault_windows.append(
            [self.now() - backdate_s, float("inf")])

    def fault_end(self, grace_s: float = 120.0) -> None:
        """Close the most recent open window; clients get ``grace_s``
        beyond it (in-flight requests finish against the fault)."""
        for window in reversed(self._fault_windows):
            if window[1] == float("inf"):
                window[1] = self.now() + grace_s
                return
        raise RuntimeError("fault_end without an open fault window")

    def _in_fault_window(self, t: float) -> bool:
        return any(lo <= t <= hi for lo, hi in self._fault_windows)

    # ---- namespace ----

    async def write_namespace(self) -> None:
        payload_rng = random.Random(self.seed + 2)
        profile = self.cluster.get_profile()
        from chunky_bits_tpu_torch.utils import aio

        for i in range(self.objects):
            name = f"obj{i:04d}"
            payload = payload_rng.randbytes(self.object_bytes)
            await self.cluster.write_file(
                name, aio.BytesReader(payload), profile)
            self.contents[name] = payload
        self.event("namespace_written", objects=self.objects,
                   bytes=self.objects * self.object_bytes)

    async def read_object(self, name: str) -> bool:
        """One client read with byte-identity check; failures are
        timestamped for the reads-clean verdict."""
        t0 = self.now()
        self.client_reads += 1
        try:
            ref = await self.cluster.get_file_ref(name)
            got = await self.cluster.file_read_builder(ref).read_all()
        # lint: broad-except-ok the client records ANY failure shape as
        # a timestamped trace event for the reads-clean verdict — the
        # scenario's assertions decide whether it was allowed
        except Exception as err:
            self._client_errors.append((t0, name, str(err)))
            self.event("client_error", object=name,
                       error=type(err).__name__)
            return False
        if got != self.contents[name]:
            self._client_errors.append((t0, name, "byte mismatch"))
            self.event("client_error", object=name,
                       error="byte-mismatch")
            return False
        return True

    def start_client(self, period_s: float = 5.0) -> None:
        """Sequential background reads, one every ``period_s`` virtual
        seconds, round-robin over the namespace with a seeded shuffle."""
        order_rng = random.Random(self.seed + 3)

        async def client() -> None:
            names = sorted(self.contents)
            while True:
                name = names[order_rng.randrange(len(names))]
                await self.read_object(name)
                await self.sleep(period_s)

        self._client_task = asyncio.ensure_future(client())

    async def stop_client(self) -> None:
        task, self._client_task = self._client_task, None
        if task is None:
            return
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    # ---- SLO engine (the detection-quality harness) ----

    def start_slo(self, spec: Optional[dict] = None) -> None:
        """Run the production SLO engine (obs/slo.py) over this
        scenario's fresh registry, ticked every ``tick_s`` VIRTUAL
        seconds.  ``spec``:

        * ``expected`` — ``{rule: {"within_s": N, "resolve": bool}}``:
          alerts that MUST fire within N virtual seconds of the first
          raw ``fault_begin`` (and, when ``resolve`` is true, be
          resolved again by scenario end);
        * ``objectives`` — SloObjectives overrides (a scenario is an
          operator tuning windows to its fleet's shape);
        * ``tick_s`` — evaluation cadence (default 15 s);
        * ``grace_s`` — how far past a fault window's close an
          expected rule's firing onset may lag (windowed detection
          trails the fault; default ``slow_s + clear_s``).

        Every transition lands in the event trace, so detection
        latency is part of the byte-identical determinism pin."""
        from chunky_bits_tpu_torch.obs import slo as obs_slo

        self.slo_spec = dict(spec or {})
        objectives = obs_slo.SloObjectives.from_obj(
            self.slo_spec.get("objectives") or None)
        self._slo_tick_s = float(self.slo_spec.get("tick_s", 15.0))

        def on_transition(rule: str, old: str, new: str, t: float,
                          value) -> None:
            self.alert_transitions.append((t, rule, old, new))
            self.trace.record(t, "alert", {
                "rule": rule, "from": old, "to": new,
                "value": None if value is None else round(value, 6)})

        self.slo_engine = obs_slo.SloEngine(
            objectives=objectives,
            registry=obs_metrics.get_registry(),
            on_transition=on_transition)

        async def ticker() -> None:
            while True:
                self.slo_engine.observe()
                await self.sleep(self._slo_tick_s)

        self._slo_task = asyncio.ensure_future(ticker())
        self.event("slo_started", tick_s=self._slo_tick_s,
                   expected=sorted(self.slo_spec.get("expected", {})))

    async def stop_slo(self) -> None:
        task, self._slo_task = self._slo_task, None
        if task is None:
            return
        task.cancel()
        try:
            await task
        except asyncio.CancelledError:
            pass

    async def settle_slo(self) -> None:
        """Post-driver settle: keep ticking until every expected
        ``resolve: true`` alert has resolved (bounded — resolution is
        itself under test, so a stuck alert times out into a failed
        verdict rather than a hung scenario)."""
        if self.slo_engine is None:
            return
        expected = self.slo_spec.get("expected", {})
        want_resolved = [rule for rule, cfg in expected.items()
                         if cfg.get("resolve", True)]
        obj = self.slo_engine.objectives
        deadline = self.now() + obj.slow_s + obj.clear_s \
            + 10.0 * self._slo_tick_s
        while self.now() < deadline:
            firing = set(self.slo_engine.firing())
            if not any(rule in firing for rule in want_resolved):
                break
            await self.sleep(self._slo_tick_s)

    def check_slo(self) -> None:
        """The per-rule detection verdicts (every scenario reports
        them — run_scenario calls this after the driver and settle):

        * ``slo_detected_<rule>`` for each expected rule: it fired,
          its first firing onset lies within ``within_s`` of the first
          raw ``fault_begin``, and (when ``resolve`` is true) it is
          resolved by scenario end;
        * ``slo_no_false_positives``: ZERO firing onsets outside the
          scripted fault windows + grace — the precision half of
          detection quality.  A non-expected rule firing INSIDE a
          declared window is a co-detection, not noise (an AZ outage
          legitimately pins the hedge budget too when hedging is
          armed); scenarios with no fault window at all are pure
          silence checks, where any firing is a false positive."""
        if self.slo_engine is None:
            return
        from chunky_bits_tpu_torch.obs import slo as obs_slo

        expected: dict = self.slo_spec.get("expected", {})
        obj = self.slo_engine.objectives
        grace_s = float(self.slo_spec.get(
            "grace_s", obj.slow_s + obj.clear_s))
        fault_t0 = (self._fault_begins[0]
                    if self._fault_begins else None)
        onsets: dict[str, list[float]] = {}
        for t, rule, _old, new in self.alert_transitions:
            if new == obs_slo.FIRING:
                onsets.setdefault(rule, []).append(t)
        final = {a.rule: a.state for a in self.slo_engine.alerts()}
        detect_latency: dict[str, float] = {}
        for rule, cfg in sorted(expected.items()):
            fired = onsets.get(rule, [])
            within = float(cfg.get("within_s", 600.0))
            t0 = fault_t0 if fault_t0 is not None else 0.0
            in_time = bool(fired) and t0 <= fired[0] <= t0 + within
            if fired:
                detect_latency[rule] = round(fired[0] - t0, 3)
            resolved_ok = True
            if cfg.get("resolve", True):
                resolved_ok = final.get(rule) == obs_slo.INACTIVE
            self.verdict(
                f"slo_detected_{rule}", in_time and resolved_ok,
                fired_at=(round(fired[0], 3) if fired else None),
                fault_t0=(round(t0, 3)),
                within_s=within,
                latency_s=detect_latency.get(rule),
                resolved=final.get(rule) == obs_slo.INACTIVE,
                resolve_required=cfg.get("resolve", True))
        false_positives = []
        for rule, times in sorted(onsets.items()):
            for t in times:
                in_window = any(lo <= t <= hi + grace_s
                                for lo, hi in self._fault_windows)
                if not in_window:
                    false_positives.append((rule, round(t, 3)))
        self.verdict("slo_no_false_positives", not false_positives,
                     false_positives=false_positives,
                     evaluations=self.slo_engine.stats().evaluations)
        self._slo_report = {
            "detect_latency_s": detect_latency,
            "false_positives": len(false_positives),
            "transitions": len(self.alert_transitions),
            "expected": sorted(expected),
        }

    def slo_report(self) -> dict:
        """The config-15 row fields (empty when no engine ran)."""
        return dict(getattr(self, "_slo_report", {}) or {})

    # ---- scrub/repair plane ----

    def start_scrub(self, replace_after_s: float = 900.0) -> None:
        from chunky_bits_tpu_torch.cluster.scrub import ScrubDaemon

        self._daemon = ScrubDaemon(
            self.cluster, bytes_per_sec=self.scrub_rate,
            interval_seconds=self.scrub_interval_s, planner=True,
            replace_after_s=replace_after_s)
        self._daemon.start()
        self.event("scrub_started",
                   interval_s=self.scrub_interval_s,
                   rate=self.scrub_rate,
                   replace_after_s=replace_after_s)

    async def stop_scrub(self) -> None:
        if self._daemon is not None:
            await self._daemon.stop()
            self.event("scrub_stopped",
                       passes=self._daemon.stats().passes)

    def scrub_stats(self):
        if self._daemon is None:
            raise RuntimeError("scrub daemon never started")
        return self._daemon.stats()

    # ---- damage scripting (direct fabric access, no client I/O) ----

    async def _locations_of(self, name: str) -> list[tuple[int, int, str]]:
        """(part index, chunk index, sim target) for every replica."""
        ref = await self.cluster.get_file_ref(name)
        out = []
        for pi, part in enumerate(ref.parts):
            for ci, chunk in enumerate(part.data + part.parity):
                for location in chunk.locations:
                    if location.is_sim():
                        out.append((pi, ci, location.target))
        return out

    async def drop_replicas(self, count: int, *,
                            avoid_zones: tuple[str, ...] = (),
                            per_part_limit: int = 1) -> int:
        """Drop ``count`` chunk replicas (sector loss: bytes vanish,
        node stays up) from nodes outside ``avoid_zones``, keeping
        every part's TOTAL damage — drops plus whatever already sits in
        the avoided (partitioned/dead) zones — within parity, so parts
        stay readable and in-place-repairable.  Never more than
        ``per_part_limit`` drops per part.  Seeded choice —
        deterministic.  Returns how many dropped."""
        dropped = 0
        hit: dict[tuple[str, int], int] = {}
        names = sorted(self.contents)
        self.rand.shuffle(names)
        for name in names:
            if dropped >= count:
                break
            locs = await self._locations_of(name)
            unreachable: dict[int, int] = {}
            for pi, _ci, target in locs:
                node, _ = fabric_mod.resolve(target)
                if node.zone in avoid_zones:
                    unreachable[pi] = unreachable.get(pi, 0) + 1
            for pi, ci, target in locs:
                if dropped >= count:
                    break
                node, chunk_name = fabric_mod.resolve(target)
                if node.zone in avoid_zones:
                    continue
                key = (name, pi)
                hits = hit.get(key, 0)
                if hits >= per_part_limit:
                    continue
                if unreachable.get(pi, 0) + hits + 1 > self.p:
                    continue  # would push the part past parity
                if node.drop(chunk_name):
                    hit[key] = hits + 1
                    dropped += 1
                    self.event("replica_dropped", object=name,
                               part=pi, chunk=ci, node=node.node_id)
        return dropped

    async def corrupt_replica(self, name: str, part: int = 0,
                              chunk: int = 0) -> bool:
        """Flip one byte of one replica of ``name`` (latent sector
        rot); offset seeded — deterministic."""
        for pi, ci, target in await self._locations_of(name):
            if pi == part and ci == chunk:
                node, chunk_name = fabric_mod.resolve(target)
                if node.corrupt(chunk_name,
                                self.rand.randrange(self.chunk_bytes)):
                    self.event("replica_corrupted", object=name,
                               part=pi, chunk=ci, node=node.node_id)
                    return True
        return False

    # ---- convergence ----

    async def namespace_valid(self) -> bool:
        from chunky_bits_tpu_torch.file import FileIntegrity

        for name in sorted(self.contents):
            try:
                report = await (await self.cluster.get_file_ref(name)
                                ).verify()
            except Exception:  # noqa: BLE001 — an unreadable ref is
                return False  # simply "not Valid yet" for convergence
            if report.integrity() != FileIntegrity.VALID:
                return False
        return True

    async def wait_converged(self, deadline_s: float,
                             check_every_s: float = 60.0) -> bool:
        """Poll the namespace until every object verifies Valid or
        ``deadline_s`` of *virtual* time passes."""
        deadline = self.now() + deadline_s
        while True:
            if await self.namespace_valid():
                self.event("converged")
                return True
            if self.now() >= deadline:
                self.event("converge_deadline_exceeded")
                return False
            await self.sleep(check_every_s)

    # ---- standard verdicts ----

    def check_reads_clean(self) -> None:
        """No client-visible error outside a scripted fault window
        (reads *inside* a window still usually succeed via
        reconstruction — an error there is the scenario's documented
        allowance, not silent breakage)."""
        stray = [(t, name, err) for t, name, err in self._client_errors
                 if not self._in_fault_window(t)]
        self.verdict("reads_clean_outside_fault", not stray,
                     stray=len(stray), total_reads=self.client_reads,
                     in_window=len(self._client_errors) - len(stray))

    def check_hedge_budget(self) -> None:
        """Hedge amplification within the token-bucket bound: fired
        hedges can never exceed ratio x primaries + the burst the
        bucket started with."""
        board = self.cluster.health_scoreboard()
        stats = board.stats()
        bound = (board.hedge_ratio * stats.primaries
                 + board.hedge_burst)
        self.verdict("hedge_within_budget",
                     stats.hedges_fired <= bound,
                     fired=stats.hedges_fired,
                     primaries=stats.primaries,
                     bound=round(bound, 2))

    def check_repair_bytes(self) -> None:
        """The config-11/13 structural bounds, exactly: decode plans
        read d x range bytes, msr plans read d' x beta, copy plans at
        most one chunk off the healthy replica (x2 slack: a replica
        that fails whole-chunk verification — raced writer — may be
        re-read off the next source once).  Helper bytes above the
        structural prediction mean the planner moved bytes nothing
        accounts for."""
        rep = self.scrub_stats().repair or {}
        d = self.d
        ok = True
        decode_b = rep.get("helper_bytes_decode", 0)
        decode_bound = rep.get("plans_decode", 0) * d * self.chunk_bytes
        if decode_b > decode_bound:
            ok = False
        msr_b = rep.get("helper_bytes_msr", 0)
        msr_bound = rep.get("plans_msr", 0) * 2 * self.chunk_bytes
        if msr_b > msr_bound:
            ok = False
        copy_b = rep.get("helper_bytes_replica", 0)
        copy_bound = rep.get("plans_copy", 0) * 2 * self.chunk_bytes
        if copy_b > copy_bound:
            ok = False
        self.verdict("repair_bytes_structural", ok,
                     helper_bytes_decode=decode_b,
                     decode_bound=decode_bound,
                     helper_bytes_msr=msr_b, msr_bound=msr_bound,
                     helper_bytes_replica=copy_b,
                     copy_bound=copy_bound)

    # ---- teardown ----

    async def close(self) -> None:
        await self.stop_client()
        await self.stop_slo()
        await self.stop_scrub()
        await self.cluster.tunables.location_context().aclose()
        self.fabric.close()


# ---- the scenario library ----

async def _az_outage(env: ScenarioEnv) -> None:
    """A full availability zone partitions away mid-scrub, sector
    losses land in the surviving zones, the zone comes back.  Repair
    of partitioned replicas must WAIT the partition out (their bytes
    are intact — no fallback/republish storm rebuilding them
    elsewhere), surviving-zone losses repair in place meanwhile, reads
    stay clean throughout (zone cap = parity), and the namespace
    converges to Valid."""
    fab = env.fabric
    # the operator knows this is an AZ outage, not dead disks: the
    # re-placement escalation is deliberately parked beyond the
    # outage so partitioned replicas are waited for, never moved
    env.start_scrub(replace_after_s=3600.0)
    env.start_client(period_s=5.0)
    await env.sleep(120.0)  # two healthy passes of warmup
    zone = fab.zones[0]
    env.fault_begin()
    env.event("az_outage_begin", zone=zone)
    fab.set_zone_state(zone, fabric_mod.PARTITIONED)
    await env.sleep(600.0)
    # sector losses in the surviving zones while degraded: one per
    # part, so parts stay readable AND repairable in place
    dropped = await env.drop_replicas(6, avoid_zones=(zone,))
    env.event("surviving_zone_losses", dropped=dropped)
    await env.sleep(900.0)
    fab.set_zone_state(zone, fabric_mod.RECOVERING)
    env.event("az_outage_end", zone=zone)
    env.fault_end(grace_s=120.0)
    await env.sleep(300.0)
    await env.stop_client()
    converged = await env.wait_converged(1800.0)
    await env.stop_scrub()
    env.verdict("converged", converged)
    env.check_reads_clean()
    env.check_repair_bytes()
    rep = env.scrub_stats().repair or {}
    # partitioned replicas came back intact: repairing them in place
    # never needed the classic resilver (no republish storm)
    env.verdict("no_fallback_storm",
                rep.get("plans_fallback", 0) == 0,
                plans_fallback=rep.get("plans_fallback", 0))


async def _rolling_restart(env: ScenarioEnv) -> None:
    """A rolling restart sweeps a quarter of the fleet (each node dead
    30 s, then recovering) under client load; no scripted damage, so
    the only acceptable outcome is zero client-visible errors and an
    untouched-Valid namespace."""
    fab = env.fabric
    env.start_scrub()
    env.start_client(period_s=4.0)
    await env.sleep(60.0)
    victims = sorted(fab.nodes)[::4]
    env.event("rolling_restart_begin", nodes=len(victims))
    for node_id in victims:
        node = fab.nodes[node_id]
        node.set_state(fabric_mod.DEAD)
        await env.sleep(30.0)
        node.set_state(fabric_mod.RECOVERING)
        await env.sleep(10.0)
    env.event("rolling_restart_end")
    await env.sleep(120.0)
    await env.stop_client()
    converged = await env.wait_converged(900.0)
    await env.stop_scrub()
    env.verdict("converged", converged)
    # restarts are not faults to the client: d-of-d+p reads ride over
    # any single dead node, so NO window is declared and every read
    # must have stayed clean
    env.check_reads_clean()
    env.check_repair_bytes()


async def _pm_msr_restart_repair(env: ScenarioEnv) -> None:
    """Single-chunk loss on a pm-msr part repaired WHILE a rolling
    restart churns the helper set: the msr plan either completes off
    2(d-1) projections or falls back cleanly to decode — and the
    ``cb_repair_*`` counters carry the pm-msr code label either way."""
    fab = env.fabric
    env.start_scrub()
    env.start_client(period_s=6.0)
    await env.sleep(60.0)
    # whole-chunk loss: every byte of one data chunk of one object
    name = sorted(env.contents)[0]
    for pi, ci, target in await env._locations_of(name):
        if pi == 0 and ci == 0:
            node, chunk_name = fabric_mod.resolve(target)
            node.drop(chunk_name)
            env.event("chunk_lost", object=name, node=node.node_id)
            break
    env.event("rolling_restart_begin")
    victims = sorted(fab.nodes)[::3]
    for node_id in victims:
        node = fab.nodes[node_id]
        node.set_state(fabric_mod.DEAD)
        await env.sleep(20.0)
        node.set_state(fabric_mod.HEALTHY)
    env.event("rolling_restart_end")
    await env.sleep(120.0)
    await env.stop_client()
    converged = await env.wait_converged(1200.0)
    await env.stop_scrub()
    env.verdict("converged", converged)
    rep = (env.scrub_stats().repair or {}).get("by_code", {})
    pm = rep.get("pm-msr", {})
    rs = rep.get("rs", {})
    # every repair this scenario performed belongs to the pm-msr label
    # (the closed-set label discipline, observed live)
    plans = (pm.get("plans_msr", 0) + pm.get("plans_decode", 0)
             + pm.get("plans_copy", 0) + pm.get("plans_fallback", 0))
    env.verdict("repair_labeled_pm_msr",
                plans >= 1 and rs.get("bytes_rebuilt", 0) == 0,
                pm_plans=plans, plans_msr=pm.get("plans_msr", 0),
                plans_decode=pm.get("plans_decode", 0))
    env.check_reads_clean()
    env.check_repair_bytes()


async def _thundering_herd(env: ScenarioEnv) -> None:
    """Everyone wants the same object while one of its replica nodes
    straggles pathologically: hedges fire, the token-bucket budget
    must cap amplification at ratio x primaries + burst even under a
    herd — and the hedge-exhaustion alert must SEE the bucket pinned
    at its cap (fired/primaries sustained at the budget slope)."""
    fab = env.fabric
    hot = sorted(env.contents)[0]
    # slow a node that actually serves the hot object — and make it a
    # pathological straggler: x400 puts its reads far past the
    # adaptive hedge-delay CEILING (20x the floor), so every read of
    # the hot part is hedge-worthy and the token bucket pins at its
    # cap (a merely-2x-slow node hides under the adaptive p95 — the
    # tail-only hedging the budget design intends)
    locs = await env._locations_of(hot)
    node, _ = fabric_mod.resolve(locs[0][2])
    node.slow_factor = 400.0
    node.set_state(fabric_mod.SLOW)
    # a straggler this bad is a fault the operator declared: reads
    # still succeed (slow, never an error), but the hedge-exhaustion
    # alert belongs to this window
    env.fault_begin(backdate_s=5.0)
    env.event("herd_begin", object=hot, slow_node=node.node_id)

    async def one_reader(i: int) -> None:
        for _ in range(6):
            await env.read_object(hot)
            await env.sleep(1.0 + (i % 7) * 0.25)

    readers = [asyncio.ensure_future(one_reader(i)) for i in range(40)]
    try:
        await asyncio.gather(*readers)
    finally:
        for task in readers:
            task.cancel()
        # cancel() only REQUESTS: when the gather above fails, the
        # surviving readers are still mid-read — without this reap
        # their teardown (hedge latency samples, budget refunds) races
        # into the healthy window below and into the determinism trace
        await asyncio.gather(*readers, return_exceptions=True)
    node.set_state(fabric_mod.HEALTHY)
    env.event("herd_end")
    env.fault_end(grace_s=30.0)
    env.check_reads_clean()  # a stall is slow, never an error
    env.check_hedge_budget()
    board = env.cluster.health_scoreboard().stats()
    env.verdict("herd_reads_served",
                env.client_reads >= 240,
                reads=env.client_reads,
                hedges_fired=board.hedges_fired,
                hedges_won=board.hedges_won)


async def _correlated_failures(env: ScenarioEnv) -> None:
    """A batch of disks in ONE zone dies for good (bytes gone, nodes
    refuse connections): the zone cap guarantees readability, and once
    the victims stay unwritable past the re-placement threshold the
    planner escalates to the classic resilver, which re-places the
    lost chunks on survivors and republishes — the namespace
    converges.  (This scenario is what exposed the planner's original
    retry-in-place-forever gap; cluster/repair.py's
    ``replace_after_s`` is the fix it pins.)"""
    fab = env.fabric
    env.start_scrub(replace_after_s=300.0)
    env.start_client(period_s=5.0)
    await env.sleep(120.0)
    zone = fab.zones[-1]
    victims = sorted(n.node_id for n in fab.nodes_in_zone(zone))[::3]
    env.fault_begin()
    env.event("correlated_failures", zone=zone, nodes=len(victims))
    for node_id in victims:
        node = fab.nodes[node_id]
        node.store.clear()  # the disk is gone, not just the process
        node.set_state(fabric_mod.DEAD)
    env.fault_end(grace_s=60.0)
    await env.sleep(300.0)
    await env.stop_client()
    converged = await env.wait_converged(2400.0)
    await env.stop_scrub()
    env.verdict("converged", converged)
    env.check_reads_clean()
    rep = env.scrub_stats().repair or {}
    env.verdict("replaced_lost_chunks",
                env.scrub_stats().repaired > 0
                or rep.get("plans_fallback", 0) > 0,
                repaired=env.scrub_stats().repaired,
                fallbacks=rep.get("plans_fallback", 0))


async def _flapping_node(env: ScenarioEnv) -> None:
    """A node flaps between erroring and healthy until its breaker
    opens; once the flapping stops, the half-open probe must recover
    it — an open breaker may never strand a live node at zero traffic
    forever."""
    fab = env.fabric
    env.start_client(period_s=2.0)
    # flap a node that actually SERVES the namespace (holder of the
    # first object's first data chunk): at fleet scale an arbitrary
    # node may hold nothing, and "traffic returned" would be vacuous
    locs = await env._locations_of(sorted(env.contents)[0])
    node, _ = fabric_mod.resolve(locs[0][2])
    env.fault_begin()
    env.event("flapping_begin", node=node.node_id)
    for _ in range(10):
        node.set_state(fabric_mod.ERRORING)
        await env.sleep(4.0)
        node.set_state(fabric_mod.HEALTHY)
        await env.sleep(2.0)
    env.event("flapping_end", node=node.node_id)
    env.fault_end(grace_s=30.0)
    ops_at_end_of_flap = node.ops
    # long quiet period under load: the cooldown elapses, a half-open
    # probe lands, the breaker closes, traffic returns
    await env.sleep(600.0)
    await env.stop_client()
    board = env.cluster.health_scoreboard()
    from chunky_bits_tpu_torch.file.location import Location

    probe = Location.sim(f"{fab.fabric_id}/{node.node_id}/probe")
    state = board.breaker_state(probe)
    env.verdict("breaker_recovered",
                state in ("closed", "half-open"),
                breaker=state)
    env.verdict("traffic_returned",
                node.ops > ops_at_end_of_flap,
                ops_during=ops_at_end_of_flap, ops_after=node.ops)
    env.check_reads_clean()


async def _slow_leak(env: ScenarioEnv) -> None:
    """Latent corruption drips in (one flipped byte per scrub
    interval, one chunk per part at a time): continuous scrub must
    detect and repair each before the next lands, reads must stay
    byte-identical throughout (reconstruction covers the window), and
    the namespace ends Valid."""
    env.start_scrub()
    env.start_client(period_s=4.0)
    names = sorted(env.contents)
    for i in range(10):
        name = names[env.rand.randrange(len(names))]
        await env.corrupt_replica(name, part=0,
                                  chunk=env.rand.randrange(env.d))
        await env.sleep(env.scrub_interval_s * 2)
    await env.stop_client()
    converged = await env.wait_converged(1200.0)
    stats = env.scrub_stats()
    await env.stop_scrub()
    env.verdict("converged", converged)
    env.verdict("corruption_detected", stats.corrupt >= 1,
                corrupt=stats.corrupt, repaired=stats.repaired)
    # corruption is exactly what parity exists for: never client-visible
    env.check_reads_clean()
    env.check_repair_bytes()


async def _disk_corruption_storm(env: ScenarioEnv) -> None:
    """The disk-fault axis (the crash harness at fleet scale): a
    burst of latent corruption lands across many nodes in one scrub
    interval — a bad firmware push, not a single rotting sector —
    while one victim node silently TEARS its next repair writes (acks
    a prefix: the crash harness's torn-write image as a live fleet
    fault) and another refuses writes disk-full for a while.  Scrub
    must detect every rotten replica through the content-address gate,
    repair must ride out torn and refused rewrites (re-detect, retry
    next pass — a torn repair is corruption again, never silent
    success), reads stay byte-identical throughout (reconstruction
    covers every window), and the namespace converges to Valid.  No
    fault window is declared: nothing here may ever be client-visible,
    and the SLO engine must stay silent (precision check)."""
    fab = env.fabric
    env.start_scrub()
    env.start_client(period_s=4.0)
    await env.sleep(90.0)
    names = sorted(env.contents)
    victims = names[:8]
    # the torn-writes node: holder of victims[0] part-0 chunk-0, which
    # we corrupt deliberately so its repair write is the one that tears
    locs = await env._locations_of(victims[0])
    torn_target = [t for pi, ci, t in locs if pi == 0 and ci == 0][0]
    torn_node, _ = fabric_mod.resolve(torn_target)
    torn_node.faults.torn_put_bytes = 64
    torn_node.faults.torn_put_remaining = 2
    # the disk-full node: holder of victims[1] part-0 chunk-1
    locs = await env._locations_of(victims[1])
    full_target = [t for pi, ci, t in locs if pi == 0 and ci == 1][0]
    full_node, _ = fabric_mod.resolve(full_target)
    full_node.faults.put_fail_status = 507
    full_node.faults.put_fail_remaining = 3
    env.event("corruption_storm_begin", victims=len(victims),
              torn_node=torn_node.node_id,
              full_node=full_node.node_id)
    burst = 0
    for i, name in enumerate(victims):
        chunk = (0 if i == 0 else
                 1 if i == 1 else env.rand.randrange(env.d))
        if await env.corrupt_replica(name, part=0, chunk=chunk):
            burst += 1
    env.event("corruption_storm_landed", corrupted=burst)
    # several scrub intervals: detect, repair, re-detect the torn
    # repairs, exhaust the fault budgets, repair for good
    await env.sleep(env.scrub_interval_s * 8)
    await env.stop_client()
    converged = await env.wait_converged(1800.0)
    stats = env.scrub_stats()
    await env.stop_scrub()
    env.verdict("converged", converged)
    env.verdict("corruption_detected", stats.corrupt >= burst,
                corrupt=stats.corrupt, burst=burst,
                repaired=stats.repaired)
    # the scripted disk faults must actually have fired (a vacuously
    # green storm proves nothing)
    env.verdict("torn_writes_ridden_out",
                torn_node.torn_writes >= 1
                and torn_node.faults.torn_put_remaining == 0,
                torn_writes=torn_node.torn_writes)
    env.verdict("disk_full_ridden_out",
                full_node.faults.put_fail_remaining == 0,
                errors_injected=full_node.errors_injected)
    # corruption is exactly what parity exists for: never client-visible
    env.check_reads_clean()
    env.check_repair_bytes()


async def _fleet_partition(env: ScenarioEnv) -> None:
    """Total connectivity loss: every zone partitions away while the
    continuous scrub runs.  The chunk bytes are all intact — the only
    thing wrong is reachability — so the correct repair response is
    NOTHING (re-placement escalation parked beyond the outage), and
    the observability story is the point: the scrub-progress-stall
    rule must detect a daemon that is up but verifying zero bytes, the
    breaker plane must mark the fleet degraded, and both alerts must
    resolve once connectivity returns and the namespace re-verifies
    Valid."""
    fab = env.fabric
    # a 1 s request timeout against unreachable peers (the fabric's
    # default 5 s stall models a patient client; an operator running
    # continuous scrub tightens it): at N=100 a 5 s stall per
    # partitioned read would stretch one scrub pass past the whole
    # outage, and the breaker plane would see too few consecutive
    # failures per node to trip before the heal
    for node in fab.nodes.values():
        node.partition_stall_s = 1.0
    env.start_scrub(replace_after_s=36000.0)
    # warm passes: the stall rule needs a progressing baseline first
    await env.sleep(180.0)
    env.fault_begin()
    env.event("fleet_partition_begin")
    for zone in fab.zones:
        fab.set_zone_state(zone, fabric_mod.PARTITIONED)
    await env.sleep(900.0)
    for zone in fab.zones:
        fab.set_zone_state(zone, fabric_mod.RECOVERING)
    env.event("fleet_partition_end")
    env.fault_end(grace_s=120.0)
    # post-heal scrub passes BEFORE stopping: breakers only recover on
    # traffic (a half-open probe needs a request to ride), and the
    # scrub walk is the traffic source this clientless scenario has —
    # exactly the operational reason a real fleet keeps scrub running
    # after an outage
    await env.sleep(300.0)
    converged = await env.wait_converged(1500.0)
    await env.stop_scrub()
    env.verdict("converged", converged)
    env.check_repair_bytes()


async def _noisy_neighbor(env: ScenarioEnv) -> None:
    """One antagonist tenant floods the read plane while a victim
    issues periodic reads — the multi-tenant QoS claim, proven
    deterministically.  THREE phases share one virtual timeline:

    1. **baseline** — the victim reads alone (no flood, no admission):
       its unloaded latency, the yardstick;
    2. **FIFO leg (QoS off)** — admission is a plain FIFO semaphore
       (the pre-QoS gateway shape): the victim's reads queue behind
       the whole antagonist backlog;
    3. **DRR leg (QoS on)** — the SAME flood through the production
       :class:`~chunky_bits_tpu_torch.cluster.qos.QosScheduler` (the exact
       class the gateway runs, here in virtual time): deficit
       round-robin rotates tenants, so the victim waits out roughly
       one rotation regardless of the antagonist backlog.

    Verdicts: the victim's p99 under DRR stays within a small factor
    of baseline AND beats the FIFO leg by the isolation factor; the
    flood itself never produces a client-visible error (reads-clean,
    no fault windows at all); the SLO engine stays silent throughout
    (precision — an antagonist tenant is load, not an outage)."""
    from chunky_bits_tpu_torch.cluster.qos import QosConfig, QosScheduler

    capacity = 8
    antagonists = 48
    victim_reads = 10
    #: virtual body-streaming time per read while the admission slot
    #: is held — the service time queue waits are measured against
    #: (the fabric's per-chunk fetch latencies are sub-millisecond at
    #: this scale; a real GET holds its slot for the whole body)
    service_s = 0.2
    names = sorted(env.contents)

    async def victim_pass(tag: str, acquire, release) -> float:
        """The victim's periodic reads through one admission shape;
        returns its p99 (max at this sample count) acquire-to-done
        latency in virtual seconds."""
        lat: list[float] = []
        for k in range(victim_reads):
            t0 = env.now()
            await acquire("victim")
            try:
                await env.read_object(names[k % len(names)])
                await env.sleep(service_s)
            finally:
                release()
            lat.append(env.now() - t0)
            await env.sleep(0.1)
        lat.sort()
        p99 = lat[min(int(len(lat) * 0.99), len(lat) - 1)]
        env.event("victim_pass", leg=tag, p99_s=round(p99, 6),
                  reads=len(lat))
        return p99

    async def flooded_pass(tag: str, acquire, release) -> float:
        """victim_pass with the antagonist flood running: every
        antagonist keeps one read permanently queued or in flight."""
        stop = False

        async def antagonist(i: int) -> None:
            while not stop:
                await acquire("antagonist")
                try:
                    await env.read_object(names[i % len(names)])
                    await env.sleep(service_s)
                finally:
                    release()

        tasks = [asyncio.ensure_future(antagonist(i))
                 for i in range(antagonists)]
        # let the flood saturate admission before the victim arrives
        await env.sleep(2.0)
        try:
            return await victim_pass(tag, acquire, release)
        finally:
            stop = True
            for task in tasks:
                task.cancel()
            # reap before the next leg: a surviving antagonist would
            # race its teardown into the other leg's latencies and the
            # determinism trace
            await asyncio.gather(*tasks, return_exceptions=True)

    # phase 1: unloaded baseline (admission is a no-op)
    async def no_acquire(tenant: str) -> None:
        return None

    baseline_p99 = await victim_pass("baseline", no_acquire,
                                     lambda: None)

    # phase 2: QoS off — FIFO admission, one global line
    sem = asyncio.Semaphore(capacity)

    async def fifo_acquire(tenant: str) -> None:
        # lint: lock-discipline-ok acquire/release are a paired
        # callable handed to victim_pass/flooded_pass, which releases
        # in its finally — the pairing spans the closure boundary
        await sem.acquire()

    fifo_p99 = await flooded_pass("fifo", fifo_acquire, sem.release)

    # phase 3: QoS on — the production scheduler, weighted victim
    config = QosConfig.from_obj({
        "tenants": {
            "victim": {"weight": 4, "keys": ["victim-key"]},
            "antagonist": {"keys": ["antagonist-key"]},
        },
    })
    sched = QosScheduler(config, read_capacity=capacity,
                         write_capacity=2, queue_timeout_s=120.0)

    async def drr_acquire(tenant: str) -> None:
        # lint: lock-discipline-ok acquire/release are a paired
        # callable handed to flooded_pass, which releases in its
        # finally — the pairing spans the closure boundary
        await sched.acquire("read", tenant, cost=env.object_bytes)

    drr_p99 = await flooded_pass("drr", drr_acquire,
                                 lambda: sched.release("read"))

    qos = sched.stats()
    env.event("noisy_neighbor_done",
              baseline_p99_s=round(baseline_p99, 6),
              fifo_p99_s=round(fifo_p99, 6),
              drr_p99_s=round(drr_p99, 6),
              qos_pressure_peak=round(qos.pressure, 4),
              victim_admitted=qos.to_obj()["tenants"]["victim"]
              ["admitted"])
    # isolation: DRR holds the victim near its unloaded latency (one
    # rotation of slack) where FIFO queues it behind the whole flood
    env.verdict("victim_isolated_under_drr",
                drr_p99 <= fifo_p99 / 3.0,
                fifo_p99_s=round(fifo_p99, 6),
                drr_p99_s=round(drr_p99, 6))
    env.verdict("victim_near_baseline_under_drr",
                drr_p99 <= max(baseline_p99 * 8.0, baseline_p99 + 1.0),
                baseline_p99_s=round(baseline_p99, 6),
                drr_p99_s=round(drr_p99, 6))
    # the flood must actually have been a flood: FIFO visibly degraded
    # the victim, else both legs trivially pass
    env.verdict("fifo_leg_degraded",
                fifo_p99 > baseline_p99 * 2.0,
                baseline_p99_s=round(baseline_p99, 6),
                fifo_p99_s=round(fifo_p99, 6))
    env.check_reads_clean()  # contention is slow, never an error


@dataclass(frozen=True)
class Scenario:
    name: str
    driver: Callable[[ScenarioEnv], Awaitable[None]]
    #: ScenarioEnv overrides (geometry, knobs) this scenario needs
    env: dict
    #: SLO detection spec (ScenarioEnv.start_slo): which alerts MUST
    #: fire (with detection bounds), objective overrides, tick cadence.
    #: Empty = pure precision check — the engine still runs and ZERO
    #: alerts may fire.
    slo: dict = field(default_factory=dict)


SCENARIOS: dict[str, Scenario] = {
    s.name: s for s in (
        # a third of the fleet partitions: the breaker plane must mark
        # it degraded (fraction over the 0.3 objective) within the
        # persistence window, and recover once the zone returns.  The
        # detection bound tracks fleet-scale physics: each partitioned
        # node trips after 5 consecutive failures, accumulated at the
        # scrub pass cadence, and partitioned reads stall 5 s each —
        # at N=100 one pass spans several virtual minutes, so the
        # fraction crosses the objective a few passes into the outage
        Scenario("az_outage", _az_outage, {
            "scrub_bytes_per_sec": 50e6, "scrub_interval_s": 60.0,
        }, slo={
            "expected": {"breaker_open": {"within_s": 1500.0,
                                          "resolve": True}},
            "objectives": {"breaker_node_fraction": 0.3},
        }),
        # restarts are routine, not faults: the engine must stay
        # SILENT through a quarter-fleet rolling restart (precision)
        Scenario("rolling_restart", _rolling_restart, {
            "scrub_bytes_per_sec": 50e6, "scrub_interval_s": 120.0,
        }),
        Scenario("pm_msr_restart_repair", _pm_msr_restart_repair, {
            "data": 5, "parity": 4, "code": "pm-msr",
            "objects": 8,
            "scrub_bytes_per_sec": 50e6, "scrub_interval_s": 90.0,
        }),
        # a herd against a straggler pins the hedge token bucket at
        # its cap: the hedge-exhaustion rule must see fired/primaries
        # at the budget slope (tight windows — the herd lives seconds)
        Scenario("thundering_herd", _thundering_herd, {
            "hedge_ms": 25.0, "objects": 8,
        }, slo={
            "expected": {"hedge_exhaustion": {"within_s": 60.0,
                                              "resolve": True}},
            "objectives": {"fast_s": 5.0, "slow_s": 10.0,
                           "clear_s": 10.0},
            "tick_s": 1.0,
        }),
        # disks die for good: the planner's re-placement escalation IS
        # the repair-fallback-storm signal (resolves once re-placed);
        # the dead zone is ~a tenth of the fleet, so breaker_open must
        # NOT fire at the 0.3 objective
        Scenario("correlated_failures", _correlated_failures, {
            "scrub_bytes_per_sec": 50e6, "scrub_interval_s": 90.0,
        }, slo={
            "expected": {"repair_fallback_storm": {"within_s": 900.0,
                                                   "resolve": True}},
        }),
        # one flapping node of many: below every fraction objective —
        # the engine must stay silent while the breaker does its job
        Scenario("flapping_node", _flapping_node, {
            "objects": 12,
        }),
        # latent corruption drips in and scrub keeps up: progress
        # never stalls, no storms — silence is the correct verdict
        Scenario("slow_leak", _slow_leak, {
            "scrub_bytes_per_sec": 50e6, "scrub_interval_s": 45.0,
        }),
        # the disk-fault axis: a corruption burst plus torn and
        # refused repair writes — all absorbed by scrub/repair, never
        # client-visible, SLO engine silent (precision check)
        Scenario("disk_corruption_storm", _disk_corruption_storm, {
            "scrub_bytes_per_sec": 50e6, "scrub_interval_s": 45.0,
            "objects": 12,
        }),
        # total connectivity loss: scrub-progress stall, fleet-wide
        # breaker degradation, AND the planner's fallback storm (every
        # pass hands every unreachable part back to the classic
        # resilver) — all three detected, all three resolving after
        # the heal
        # an antagonist tenant floods reads: load, not an outage — the
        # engine must stay silent (precision) while the QoS verdicts
        # prove weighted-fair isolation of the victim tenant
        Scenario("noisy_neighbor", _noisy_neighbor, {
            "objects": 8,
        }),
        Scenario("fleet_partition", _fleet_partition, {
            "scrub_bytes_per_sec": 50e6, "scrub_interval_s": 60.0,
        }, slo={
            "expected": {
                "scrub_stall": {"within_s": 600.0, "resolve": True},
                "breaker_open": {"within_s": 600.0, "resolve": True},
                "repair_fallback_storm": {"within_s": 300.0,
                                          "resolve": True},
            },
            "objectives": {"scrub_stall_s": 240.0},
        }),
    )
}


def run_scenario(name: str, *, nodes: int = 100, seed: int = 0,
                 workdir: str, objects: Optional[int] = None
                 ) -> ScenarioResult:
    """Run one library scenario to completion on a fresh virtual-time
    loop and a fresh metrics registry; returns the result row.  Wall
    time is measured on the always-real system clock (the virtual
    clock is installed process-wide for the duration)."""
    scenario = SCENARIOS.get(name)
    if scenario is None:
        raise ValueError(
            f"unknown scenario {name!r} (know {sorted(SCENARIOS)})")
    env_kwargs = dict(scenario.env)
    if objects is not None:
        env_kwargs["objects"] = objects
    real = _clock.system_clock()
    wall0 = real.monotonic()
    # warm the process-shared host pipeline BEFORE the registry swap:
    # it self-registers at construction, and its busy/idle counters
    # are wall-clock seconds — they belong to the production registry,
    # never to a scenario's deterministic snapshot
    from chunky_bits_tpu_torch.parallel.host_pipeline import get_host_pipeline

    get_host_pipeline()
    previous_registry = obs_metrics.swap_registry(
        obs_metrics.MetricsRegistry())
    # ScenarioEnv reseeds the process-global `random` (the read/write
    # paths' jitter draws must replay run-to-run); bracket it so the
    # reseed cannot leak determinism into whatever runs after us in
    # the same process (later tests, other smoke legs)
    previous_random_state = random.getstate()

    async def main() -> tuple[ScenarioEnv, float, dict]:
        env = ScenarioEnv(name, workdir, nodes=nodes, seed=seed,
                          **env_kwargs)
        try:
            env.event("scenario_begin", scenario=name, nodes=nodes,
                      seed=seed)
            await env.write_namespace()
            # EVERY scenario runs the SLO engine — scenarios with no
            # `slo` spec are precision runs (zero alerts may fire);
            # started after the namespace write so the warmup I/O burst
            # is not part of the observed story, before the driver so
            # the quiet period ahead of the fault is
            env.start_slo(scenario.slo)
            await scenario.driver(env)
            await env.settle_slo()
            env.check_slo()
            env.event("scenario_end", scenario=name)
            virtual = env.now()
            metrics = obs_metrics.get_registry().snapshot()
            return env, virtual, metrics
        finally:
            await env.close()

    try:
        env, virtual, metrics = sim_loop.run(main())
    finally:
        obs_metrics.swap_registry(previous_registry)
        random.setstate(previous_random_state)
    return ScenarioResult(
        name=name, seed=seed, nodes=nodes,
        virtual_seconds=virtual,
        wall_seconds=real.monotonic() - wall0,
        trace=env.trace.to_bytes(),
        metrics=metrics,
        verdicts=dict(env.verdicts),
        details={"client_reads": env.client_reads,
                 "fabric": env.fabric.stats(),
                 "slo": env.slo_report()},
    )


def fresh_workdir(path: str) -> str:
    """Reset ``path`` to an empty directory (determinism runs reuse
    one path so metadata locations are string-identical run to run)."""
    import os

    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path
