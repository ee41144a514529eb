"""Continuous scrub and repair daemon: verify data before a client finds
it corrupt (the port of ``chunky_bits_tpu/cluster/scrub.py``).

The reference verifies only on demand (src/file/file_part.rs:228-251).
The daemon walks every file reference of the cluster's metadata store on
a cycle, re-hashes each chunk replica against its digest on the shared
``HostPipeline``, feeds corruption demerits into the cluster's
``HealthScoreboard`` and repairs what it found: through the
``RepairPlanner`` (cluster/repair.py) by default, whose decode and msr
plans run on the cluster's erasure backend (the GF(2^8) kernel on a
``cuda`` cluster), with the classic ``resilver`` as its fallback.

**Byte-rate bound.**  Scrub I/O competes with client traffic, so the
walk is token-bucket bounded: ``tunables.scrub_bytes_per_sec``
(``$CHUNKY_BITS_TORCH_SCRUB_BYTES_PER_SEC``; YAML wins) is the sustained
budget, with a one-second burst.  0 (the default) means the gateway
builds no daemon at all.  The bucket runs on the clock seam
(``cluster/clock.py``).

**Priority.**  Files with a replica on a degraded node (per the
scoreboard) go first, then, on a meta-log store, the files published
since the previous pass (the ``changes(since_generation)`` feed), then
the cold tail.  On a meta-log store the pre-scan is a pure index scan
and refs are fetched one ``FETCH_PAGE`` at a time; on a path store the
pass reads each ref once into one snapshot.

**Hashing.**  A local or slab replica is hashed in one native read+hash
pass (``file_part._hash_local_fused``), its bytes never reaching Python,
so the planner re-reads a corrupt one to localize the damage, as in the
JAX package.  Any other replica is read and verified on the host
pipeline, and a corrupt one's bytes go to the planner, which localizes
from them without a re-read.

**Concurrency.**  The daemon is a plain asyncio task on its caller's
loop; ``stop()`` cancels and awaits it.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from dataclasses import dataclass
from typing import Callable, Optional

from chunky_bits_tpu_torch.cluster import clock as _clock
from chunky_bits_tpu_torch.errors import ChunkyBitsError, LocationError

log = logging.getLogger("chunky_bits_tpu_torch.scrub")


def _canonical(obj: object) -> str:
    """Canonical serialization of a metadata object — the scrub repair
    fence compares the stored bytes' *meaning*, so a format-level
    rewrite (key order, yaml vs json) never reads as a client write."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def _ref_from_obj(obj: object):
    from chunky_bits_tpu_torch.file.file_reference import FileReference

    return FileReference.from_obj(obj)


class TokenBucket:
    """Sustained byte-rate bound with a one-second burst.  ``take(n)``
    sleeps until ``n`` bytes of budget have accrued; oversized requests
    (one chunk larger than the burst) drive the balance negative so the
    *average* still honors the rate.  A rate of 0 disables the bound
    (take returns immediately) — the daemon itself is not constructed
    at rate 0, but --once CLI runs may scrub unthrottled.

    An optional pressure hook (:meth:`set_pressure`, which the gateway's
    QoS scheduler drives, cluster/qos.py) scales *accrual* by
    ``1 - pressure`` with a :data:`MIN_ACCRUAL` floor: under full
    client-admission pressure scrub/repair I/O degrades to 5% of its
    budget but NEVER stops accruing — a stuck pressure signal slows
    the scrub walk, it cannot hang it (degrade, never hang)."""

    #: bound on a single sleep slice so cancellation (daemon stop)
    #: is always prompt
    MAX_SLEEP = 0.5

    #: accrual floor under full pressure — background I/O yields to
    #: client traffic but keeps a liveness trickle
    MIN_ACCRUAL = 0.05

    def __init__(self, rate: float) -> None:
        self.rate = max(float(rate), 0.0)
        self._balance = self.rate  # start with one second of burst
        self._last = _clock.monotonic()
        self._pressure: Optional[Callable[[], float]] = None

    def set_pressure(self, fn: Optional[Callable[[], float]]) -> None:
        """Install (or clear) the gateway pressure signal in [0, 1];
        accrual scales by ``max(1 - pressure, MIN_ACCRUAL)``."""
        self._pressure = fn

    def _effective_rate(self) -> float:
        """Accrual rate after the pressure throttle — the ONE number
        both accrual and the wait estimate must use: waiting at the
        unthrottled rate while accruing at the throttled one recovers
        only ``1 - pressure`` of each wait, an asymptotic (Zeno) loop
        that never reaches zero."""
        rate = self.rate
        if self._pressure is not None:
            p = min(max(float(self._pressure()), 0.0), 1.0)
            rate *= max(1.0 - p, self.MIN_ACCRUAL)
        return rate

    def _accrue(self) -> None:
        now = _clock.monotonic()
        self._balance = min(
            self._balance + (now - self._last) * self._effective_rate(),
            self.rate)
        self._last = now

    async def take(self, nbytes: int) -> None:
        if self.rate <= 0:
            return
        self._accrue()
        self._balance -= nbytes
        while self._balance < 0:
            wait = min(-self._balance / self._effective_rate(),
                       self.MAX_SLEEP)
            # floor the slice: float rounding (or pressure rising
            # between estimate and accrual) must never shrink waits
            # toward zero without the balance reaching it
            await _clock.sleep(max(wait, 0.001))
            self._accrue()


@dataclass
class ScrubStats:
    """Counter snapshot — the ``Scrub<...>`` profiler stanza and the
    gateway's ``/scrub/status`` payload."""

    passes: int
    files_scanned: int
    chunks_scanned: int
    bytes_verified: int
    corrupt: int
    unavailable: int
    repaired: int
    repair_failures: int
    rate_bytes_per_sec: float
    running: bool
    last_pass_seconds: Optional[float]
    #: the repair planner's counter snapshot (RepairStats.to_obj), or
    #: None when the daemon runs with the legacy repair shape
    repair: Optional[dict] = None

    def to_obj(self) -> dict:
        return {
            "running": self.running,
            "passes": self.passes,
            "files_scanned": self.files_scanned,
            "chunks_scanned": self.chunks_scanned,
            "bytes_verified": self.bytes_verified,
            "corrupt": self.corrupt,
            "unavailable": self.unavailable,
            "repaired": self.repaired,
            "repair_failures": self.repair_failures,
            "rate_bytes_per_sec": self.rate_bytes_per_sec,
            **({"last_pass_seconds": round(self.last_pass_seconds, 3)}
               if self.last_pass_seconds is not None else {}),
            **({"repair": self.repair}
               if self.repair is not None else {}),
        }

    def __str__(self) -> str:
        rate = (f"{self.rate_bytes_per_sec:.0f}B/s"
                if self.rate_bytes_per_sec > 0 else "unbounded")
        plans = ""
        if self.repair is not None:
            # c=copy d=decode m=msr(pm-msr regeneration) f=fallback
            plans = (f" plans={self.repair.get('plans_copy', 0)}c/"
                     f"{self.repair.get('plans_decode', 0)}d/"
                     f"{self.repair.get('plans_msr', 0)}m/"
                     f"{self.repair.get('plans_fallback', 0)}f")
            ratio = self.repair.get("helper_bytes_per_rebuilt_byte")
            if ratio is not None:
                plans += f" helperB/rebuiltB={ratio:.2f}"
        return (f"Scrub<scanned={self.files_scanned}f/"
                f"{self.chunks_scanned}c "
                f"verified={self.bytes_verified}B "
                f"corrupt={self.corrupt} repaired={self.repaired}"
                f"{plans} | rate={rate}>")


class ScrubDaemon:
    """One cluster's scrub/repair loop.

    ``run_once`` is a single full pass (the CLI's ``scrub --once``);
    ``start``/``stop`` run passes continuously with ``interval_seconds``
    of idle between them (the gateway's long-running mode).  ``repair``
    False turns detection-only mode on (report + demerit, never write).

    ``planner`` True (the default) routes repair through the targeted
    ``RepairPlanner`` (cluster/repair.py): block-localized ranged reads,
    health-picked helpers, exact per-plan byte metering, in-place
    rewrites that never republish metadata; the classic full
    ``resilver`` runs only as its fallback.  ``planner`` False keeps
    the legacy shape end to end — whole-replica copy beside a healthy
    one, part-granular resilver for lost chunks (the OFF leg of the
    JAX package's repair-bandwidth A/B, ``bench.py --config 11``).

    ``profiler`` (a file.profiler.Profiler) rides every location I/O
    the pass makes: the per-read byte accounting that measures helper
    traffic; None (the default) logs nothing.

    ``replace_after_s`` is the planner's re-placement escalation
    threshold (cluster/repair.py): a replica unwritable for this long
    is treated as permanently lost and its part resilvered to a NEW
    location; below it, in-place repair retries next pass (transient
    partitions are waited out, never answered with a republish storm).
    """

    #: parsed refs fetched per batch on the index-pre-scan path — the
    #: pass's peak object memory, and the grouped-read granularity
    FETCH_PAGE = 256

    def __init__(self, cluster, bytes_per_sec: Optional[float] = None,
                 interval_seconds: float = 60.0, repair: bool = True,
                 profile_name: Optional[str] = None,
                 planner: bool = True, profiler=None,
                 replace_after_s: float = 900.0) -> None:
        self.cluster = cluster
        rate = (cluster.tunables.scrub_bytes_per_sec
                if bytes_per_sec is None else float(bytes_per_sec))
        self.rate = max(rate, 0.0)
        self.interval_seconds = max(float(interval_seconds), 0.0)
        self.repair = repair
        self.profile_name = profile_name
        self.profiler = profiler
        self._bucket = TokenBucket(self.rate)
        if planner:
            from chunky_bits_tpu_torch.cluster.repair import RepairPlanner

            self._planner: Optional[RepairPlanner] = RepairPlanner(
                health=cluster.health_scoreboard(),
                bucket=self._bucket,
                backend=cluster.tunables.backend,
                replace_after_s=replace_after_s,
                # the continuity bound must out-span the retry cadence:
                # failures recur once per pass, so with interval >
                # replace_after_s every pass would otherwise look like
                # a fresh (stale-reset) streak and escalation could
                # never fire
                stale_after_s=max(replace_after_s,
                                  2.0 * float(interval_seconds)))
        else:
            self._planner = None
        self._task: Optional[asyncio.Task] = None
        #: high-water generation cursor for the meta-log ``changes()``
        #: tail feed (0 = everything is new); only ever touched from
        #: the pass loop, so unguarded
        self._seen_generation = 0
        # counters are read by profiler reports and the gateway status
        # handler (possibly from another thread than the pass loop's)
        self._lock = threading.Lock()
        self._passes = 0
        self._files = 0
        self._chunks = 0
        self._bytes = 0
        self._corrupt = 0
        self._unavailable = 0
        self._repaired = 0
        self._repair_failures = 0
        self._last_pass_seconds: Optional[float] = None
        # weakly self-register with the process metrics registry so a
        # /metrics scrape reports scrub progress (the counters are
        # already lock-guarded for exactly this cross-thread read)
        from chunky_bits_tpu_torch.obs.metrics import get_registry

        get_registry().register_source("scrub", self)

    # ---- reporting ----

    def _bump(self, **deltas: int) -> None:
        with self._lock:
            for key, delta in deltas.items():
                setattr(self, f"_{key}", getattr(self, f"_{key}") + delta)

    def stats(self) -> ScrubStats:
        with self._lock:
            return ScrubStats(
                passes=self._passes,
                files_scanned=self._files,
                chunks_scanned=self._chunks,
                bytes_verified=self._bytes,
                corrupt=self._corrupt,
                unavailable=self._unavailable,
                repaired=self._repaired,
                repair_failures=self._repair_failures,
                rate_bytes_per_sec=self.rate,
                running=self._task is not None and not self._task.done(),
                last_pass_seconds=self._last_pass_seconds,
                repair=(self._planner.stats().to_obj()
                        if self._planner is not None else None),
            )

    # ---- the walk ----

    async def _list_file_paths(self) -> list[str]:
        """Every file path in the metadata store (depth-first; per-dir
        failures skip the subtree rather than abort the pass — a scrub
        must survive a half-broken namespace)."""
        out: list[str] = []
        stack = ["."]
        while stack:
            path = stack.pop()
            try:
                entries = await self.cluster.list_files(path)
            except ChunkyBitsError:
                continue
            for entry in entries:
                if str(entry.path) in (".", path):
                    continue  # the listing's own top entry
                if entry.is_directory():
                    stack.append(entry.path)
                elif entry.is_file():
                    out.append(entry.path)
        return out

    async def _namespace_refs(self) -> list[tuple[str, object]]:
        """(path, parsed metadata obj) for every file in the namespace,
        each ref's bytes read exactly ONCE for the whole pass.  A
        meta-log store serves this from one index scan plus grouped
        sequential log reads (``namespace_snapshot``); the legacy
        file-per-ref store falls back to the recursive walk with one
        read per path.  Either way the priority pre-scan and the verify
        walk below share this single read — the old shape read every
        ref TWICE per pass (once to score, once to scrub), which at
        namespace scale doubled the pass's metadata cost on both
        stores."""
        metadata = self.cluster.metadata
        snapshot = getattr(metadata, "namespace_snapshot", None)
        if snapshot is not None:
            try:
                return list(await snapshot())
            except ChunkyBitsError:
                # a single foreign/corrupt ref poisons the batched
                # read; the per-path walk below skips just that entry
                # (a scrub must survive a half-broken namespace)
                pass
        out: list[tuple[str, object]] = []
        for path in await self._list_file_paths():
            try:
                out.append((path, await metadata.read(path)))
            except ChunkyBitsError:
                continue  # unparseable/foreign metadata: skip
        return out

    async def _recent_paths(self) -> frozenset:
        """Paths published since the previous pass, from the meta-log
        ``changes(since_generation)`` tail feed — empty on stores
        without one (and after a compaction dropped the cursor's
        window, which simply reads as nothing-recent).  One bounded
        page per pass: a hint tier, not an audit log."""
        changes = getattr(self.cluster.metadata, "changes", None)
        if changes is None:
            return frozenset()
        try:
            rows = await changes(self._seen_generation)
        except ChunkyBitsError:
            return frozenset()
        if rows:
            self._seen_generation = max(r.generation for r in rows)
        return frozenset(r.name for r in rows if not r.tombstone)

    async def _index_prescan(self) -> Optional[list[tuple[int, str]]]:
        """Priority-scored (prio, path) for the whole namespace from
        ONE meta-log index scan — zero ref reads, zero parses: each
        ref's publish-time node keys (``namespace_nodes``) are
        intersected with the scoreboard's degraded-key set, and the
        ``changes()`` feed promotes fresh writes, exactly like the
        snapshot path scores below.  None on stores without the
        projection (legacy store, or any ref published without one) —
        the caller falls back to the full snapshot read, so scoring is
        never silently partial."""
        index = getattr(self.cluster.metadata, "namespace_nodes", None)
        if index is None:
            return None
        try:
            rows = await index()
        except ChunkyBitsError:
            return None
        if rows is None:
            return None
        recent = await self._recent_paths()
        degraded = self.cluster.health_scoreboard().degraded_keys()
        out: list[tuple[int, str]] = []
        for path, nodes in rows:
            prio = 2
            if degraded and any(key in degraded for key in nodes):
                prio = 0
            elif path in recent:
                prio = 1
            out.append((prio, path))
        return out

    async def _fetch_objs(self, paths: list) -> dict:
        """path -> parsed metadata obj for one page of the verify walk
        (index-pre-scan path only).  Batched through the meta-log's
        ``read_objs`` (grouped sequential log reads); a poisoned batch
        or a store without one degrades to per-path reads, and per-path
        failures skip just that entry — a scrub must survive a
        half-broken namespace."""
        if not paths:
            return {}
        metadata = self.cluster.metadata
        reader = getattr(metadata, "read_objs", None)
        if reader is not None:
            try:
                return dict(await reader(paths))
            except ChunkyBitsError:
                pass  # isolate the bad entry via the per-path loop
        out: dict = {}
        for path in paths:
            try:
                out[path] = await metadata.read(path)
            except ChunkyBitsError:
                continue
        return out

    def _ref_priority(self, ref) -> int:
        """0 = any chunk replica lives on a degraded node (scan first),
        2 = all-healthy (``run_once`` promotes recently-written
        all-healthy refs to tier 1 via the ``changes()`` feed — fresh
        writes get verified before the cold tail of the namespace).
        With no health data and no recency feed every ref scores 2 and
        the pass order is the plain namespace order."""
        health = self.cluster.health_scoreboard()
        for part in ref.parts:
            for chunk in part.data + part.parity:
                for location in chunk.locations:
                    if health.degraded(location):
                        return 0
        return 2

    async def _verify_chunk(self, chunk, location, cx, pipe
                            ) -> tuple[Optional[bool], Optional[bytes]]:
        """(verdict, corrupt bytes): verdict True = the replica matches
        its digest, False = corrupt, None = unreadable.  The native fused
        read+hash where the replica is local or packed in a slab (no bytes
        come back); otherwise a read verified on the host pipeline, whose
        bytes ride back when corrupt, so the repair planner localizes the
        damage without re-reading the victim.  The byte budget is taken
        BEFORE the I/O: the bound meters bytes touched, not bytes that
        verified."""
        from chunky_bits_tpu_torch.file.file_part import _hash_local_fused

        try:
            nbytes = await location.file_len(cx)
        except LocationError:
            return None, None
        await self._bucket.take(nbytes)
        digest = await _hash_local_fused(chunk, location, cx, pipe)
        if digest is not None:
            self._bump(bytes=nbytes)
            return digest == chunk.hash.value.digest, None
        try:
            data = await location.read(cx)
        except LocationError:
            return None, None
        self._bump(bytes=len(data))
        ok = await pipe.run(
            "verify", lambda: chunk.hash.verify(data),
            nbytes=len(data))
        return bool(ok), (None if ok else bytes(data))

    async def _rewrite_replicas(self, chunk, source, victims, cx,
                                pipe) -> None:
        """Overwrite corrupt/missing replicas of ``chunk`` in place
        with the verified bytes from ``source`` (content-addressed, so
        an overwrite matching the hash is always safe — the same
        rationale as resilver's overwrite deviation).  Reads and
        writes are metered through the byte budget like verification
        is."""
        from chunky_bits_tpu_torch.file.location import OVERWRITE

        try:
            nbytes = await source.file_len(cx)
            await self._bucket.take(nbytes)
            data = await source.read(cx)
        except LocationError:
            return  # the healthy replica vanished: next pass decides
        ok = await pipe.run(
            "verify", lambda: chunk.hash.verify(data),
            nbytes=len(data))
        if not ok:
            return  # raced a writer; don't spread unverified bytes
        overwrite_cx = cx.but_with(on_conflict=OVERWRITE)
        for victim in victims:
            await self._bucket.take(len(data))
            try:
                await victim.write(data, overwrite_cx)
            except LocationError:
                # node still down/full: counted, retried next pass
                self._bump(repair_failures=1)
                continue
            self._bump(repaired=1)

    async def _scrub_ref(self, path: str, ref, cx, pipe,
                         snapshot: str) -> None:
        """Verify every replica of every chunk of one file, then repair
        the damage.  With the planner (the default) repair is targeted
        and in place — block-localized ranged reads, health-picked
        helpers, no metadata republish — and only parts the planner
        hands back fall through to the classic full ``resilver``; with
        ``planner=False`` every damaged part takes the legacy sequence
        (whole-replica rewrite beside a healthy one, part-granular
        resilver for lost chunks), the same as the CLI's ``resilver``
        command.  ``snapshot`` is the canonical serialized form of
        ``ref`` as fetched — the resilver republish is fenced on the
        stored metadata still matching it, so a client overwrite that
        landed while this (rate-bounded, possibly long) scrub was
        running is never clobbered with a stale repaired ref."""
        health = self.cluster.health_scoreboard()
        damaged_parts = []
        for part in ref.parts:
            # verify phase: one verdict per replica (True verified,
            # False corrupt, None unreadable) — the planner's input
            verdicts = []
            # corrupt-replica bytes the generic verify path already
            # surfaced, keyed (chunk index, location) — the planner
            # localizes from these instead of re-reading the victim;
            # scoped to ONE part, so memory stays bounded by the
            # (rare) corrupt replicas of the part in hand
            payloads: dict = {}
            part_damaged = False
            for ci, chunk in enumerate(part.data + part.parity):
                self._bump(chunks=1)
                per_loc = []
                if not chunk.locations:
                    # a chunk with no replicas at all: nothing to
                    # verify, but the part needs repair (resilver
                    # places a new replica — the planner hands it back)
                    part_damaged = True
                for location in chunk.locations:
                    verdict, payload = await self._verify_chunk(
                        chunk, location, cx, pipe)
                    if verdict is False:
                        # corrupt content on a successful transfer is
                        # still a demerit for the node serving it —
                        # the same rule as the read path's _corrupt
                        self._bump(corrupt=1)
                        health.record(location, False)
                        part_damaged = True
                        if payload is not None:
                            payloads[(ci, location)] = payload
                    elif verdict is None:
                        self._bump(unavailable=1)
                        part_damaged = True
                    per_loc.append((location, verdict))
                verdicts.append(per_loc)
            if not part_damaged or not self.repair:
                continue
            if self._planner is not None:
                outcome = await self._planner.repair_part(
                    part, verdicts, cx, pipe, payloads=payloads)
                self._bump(repaired=outcome.repaired,
                           repair_failures=outcome.failures)
                if outcome.fallback:
                    damaged_parts.append(part)
                continue
            # legacy shape (planner=False): whole-replica
            # rewrite beside a healthy one — resilver only rebuilds
            # chunks with NO valid replica (chunk_status
            # short-circuit), so without this the same rotten extent
            # would be re-detected (and the node re-demerited) every
            # pass forever — and part-granular resilver for the rest
            part_lost = False
            for chunk, per_loc in zip(part.data + part.parity,
                                      verdicts):
                good = next(
                    (loc for loc, v in per_loc if v is True), None)
                victims = [loc for loc, v in per_loc if v is not True]
                if good is None:
                    part_lost = True
                elif victims:
                    await self._rewrite_replicas(chunk, good, victims,
                                                 cx, pipe)
            if part_lost:
                damaged_parts.append(part)
        self._bump(files=1)
        if not damaged_parts or not self.repair:
            return
        profile = self.cluster.get_profile(self.profile_name)
        if profile is None:
            self._bump(repair_failures=len(damaged_parts))
            return
        destination = self.cluster.get_destination(profile)
        for part in damaged_parts:
            # repair I/O is charged to the same byte budget as
            # verification, at part granularity: resilver re-reads
            # every replica and writes the rebuilt shards, so a
            # mass-repair pass after a node loss must throttle like
            # the scan does instead of saturating disks at full speed
            replicas = sum(len(c.locations)
                           for c in part.data + part.parity)
            await self._bucket.take(part.chunksize * (replicas + 1))
            try:
                report = await part.resilver(
                    destination, cx,
                    backend=self.cluster.tunables.backend,
                    pipeline=pipe)
            # a failed repair is a counter and a
            # retry next pass, never a dead daemon mid-namespace
            # lint: broad-except-ok a failed repair is a counter and a
            # retry next pass, never a dead daemon mid-namespace
            except Exception:
                self._bump(repair_failures=1)
                continue
            if report.successful_writes() and not report.failed_writes():
                self._bump(repaired=1)
            elif report.failed_writes():
                self._bump(repair_failures=1)
        try:
            # republish fence: only write back if the stored metadata
            # still matches what this scrub read — an overwrite that
            # raced the pass wins, and its chunks get scrubbed next
            # pass instead of being reverted to a stale ref.  (The
            # remaining window between this read and the write is one
            # metadata round-trip, not a whole rate-bounded pass.)
            current = _canonical(await self.cluster.metadata.read(path))
            if current != snapshot:
                return
            await self.cluster.write_file_ref(path, ref)
        except ChunkyBitsError:
            self._bump(repair_failures=1)

    async def run_once(self) -> ScrubStats:
        """One full pass over the namespace: degraded-resident files
        first, recently-written files next, the healthy cold tail last.
        Returns the cumulative stats snapshot.

        On a meta-log store the priority pre-scan is a pure INDEX scan
        (``_index_prescan``: per-ref node keys intersected with the
        scoreboard's degraded set — zero ref reads, zero parses), and
        the verify walk fetches parsed refs lazily in priority order,
        one page at a time (``_fetch_objs`` -> ``read_objs``: grouped
        sequential log reads), so pass memory peaks at the index plus
        ONE page of objects and degraded-tier scrubbing starts
        immediately instead of after a full-namespace read.  On the
        legacy store the pass falls back to one full snapshot
        (``_namespace_refs`` — each ref's bytes still read exactly
        once; the old shape read every ref twice).  Holding scored
        paths across a (rate-bounded, possibly hours-long) pass is
        safe from clobbering client writes because the repair
        republish is FENCED on a fresh metadata read still matching
        the obj as fetched (``_scrub_ref``) — a raced overwrite wins,
        and chunk rewrites are content-addressed in-place either way.
        NOTE: scoring and fetching bypass ``get_file_ref`` — a pass
        must not churn the serving path's file-ref LRU (it would evict
        every hot ref the gateway is using)."""
        started = _clock.monotonic()
        cx = self.cluster.tunables.location_context()
        if self.profiler is not None:
            # per-read byte accounting for the pass
            cx = cx.but_with(profiler=self.profiler)
        pipe = self.cluster.host_pipeline()
        scored: list[tuple[int, str, object]] = []
        plan = await self._index_prescan()
        if plan is not None:
            scored = [(prio, path, None) for prio, path in plan]
        else:
            refs = await self._namespace_refs()
            recent = await self._recent_paths()
            for path, obj in refs:
                try:
                    ref = _ref_from_obj(obj)
                except ChunkyBitsError:
                    continue  # unparseable/foreign metadata: skip
                prio = self._ref_priority(ref)
                if prio != 0 and path in recent:
                    prio = 1
                scored.append((prio, path, obj))
            del refs, recent
        # stable by priority only: within a tier the index's own order
        # (namespace order) is preserved, like the old pass
        scored.sort(key=lambda t: t[0])
        scored.reverse()  # pop() below consumes from the front
        while scored:
            page = [scored.pop()
                    for _ in range(min(self.FETCH_PAGE, len(scored)))]
            fetched = await self._fetch_objs(
                [path for _prio, path, obj in page if obj is None])
            for _prio, path, obj in page:
                if obj is None:
                    obj = fetched.get(path)
                    if obj is None:
                        continue  # deleted/raced since the pre-scan
                try:
                    snapshot = _canonical(obj)
                    ref = _ref_from_obj(obj)
                except ChunkyBitsError:
                    continue
                await self._scrub_ref(path, ref, cx, pipe, snapshot)
        with self._lock:
            self._passes += 1
            self._last_pass_seconds = _clock.monotonic() - started
        return self.stats()

    # ---- daemon lifetime ----

    def set_pressure(self,
                     fn: Optional[Callable[[], float]]) -> None:
        """Forward the gateway QoS pressure signal to the daemon's
        token bucket — the ONE bucket every scrub and planner-repair
        byte charges, so one hook throttles both (priority ordering:
        client traffic > scrub/repair)."""
        self._bucket.set_pressure(fn)

    async def _run_forever(self) -> None:
        while True:
            try:
                await self.run_once()
            except asyncio.CancelledError:
                raise
            # a failed pass must never silently
            # end continuous scrubbing for the process's remaining
            # lifetime; logged, and the next interval retries
            # lint: broad-except-ok a failed pass must never silently
            # end continuous scrubbing for the process's remaining
            # lifetime; logged, and the next interval retries
            except Exception:
                log.exception("scrub pass failed; retrying after "
                              "interval")
            if self.interval_seconds <= 0:
                # rate-bounded back-to-back passes still yield between
                # chunks via the bucket; give the loop one tick anyway
                await asyncio.sleep(0)
                continue
            await _clock.sleep(self.interval_seconds)

    def start(self) -> None:
        """Start the continuous loop on the running event loop.
        Idempotent while running; a finished or crashed task
        restarts."""
        if self._task is not None and not self._task.done():
            return
        self._task = asyncio.ensure_future(self._run_forever())

    async def stop(self) -> None:
        """Cancel AND await the pass loop — stop() returning means no
        scrub task survives (the no-leaked-tasks contract)."""
        task, self._task = self._task, None
        if task is None:
            return
        task.cancel()
        try:
            # the task was cancelled on the
            # line above and every wait inside the pass loop is a
            # bounded sleep slice (TokenBucket.MAX_SLEEP) or bounded
            # I/O, so cancellation delivery is prompt by construction
            # lint: unbounded-await-ok the task was cancelled on the
            # line above and every wait inside the pass loop is a
            # bounded sleep slice (TokenBucket.MAX_SLEEP) or bounded
            # I/O, so cancellation delivery is prompt by construction
            await task
        except asyncio.CancelledError:
            pass
        # stop() returning means the task is
        # gone — a pass that died with a stray exception must not
        # re-raise here and abort the caller's shutdown sequence
        # (gateway serve's finally runs runner.cleanup after this)
        # lint: broad-except-ok stop() returning means the task is
        # gone — a pass that died with a stray exception must not
        # re-raise here and abort the caller's shutdown sequence
        # (gateway serve's finally runs runner.cleanup after this)
        except Exception:
            log.exception("scrub task ended with an error")


def maybe_build(cluster, **kwargs) -> Optional[ScrubDaemon]:
    """A daemon for ``cluster`` when its ``scrub_bytes_per_sec`` tunable
    asks for one, else None — THE off-by-default gate: at rate 0 no
    daemon object exists, no task runs, nothing is imported at serve
    time beyond this check."""
    if cluster.tunables.scrub_bytes_per_sec <= 0:
        return None
    return ScrubDaemon(cluster, **kwargs)
