"""Targeted repair planner: block-localized, health-scheduled,
byte-metered resilver (the port of ``chunky_bits_tpu/cluster/repair.py``).

The reference repairs a whole part (``FilePart::resilver``,
src/file/file_part.rs:253-389, re-reads every replica of every chunk).
RS here is applied stripe-wise (byte ``s`` of every shard is one GF(2^8)
stripe), so a damaged byte range of one chunk is rebuilt from the same
range of ``d`` helpers.  The optional per-chunk block-digest tree
(file/chunk.py ``BlockDigests``, written when
``tunables.repair_block_bytes`` is set) localizes the damage first.

Four plan kinds, cheapest first:

* **copy**: the chunk still has a healthy replica; read the damaged
  ranges (or the whole chunk) from it and rewrite the victims in place.
* **msr**: a ``pm-msr`` part (ops/pm_msr.py) lost exactly one chunk;
  regenerate it from β-sized projections of the healthiest
  ``d' = 2(d-1)`` helper chunks (computed on the host pipeline through
  the part's backend), combined by one ``[α, d']`` product, also through
  the backend: ``2·chunksize`` helper bytes instead of ``d·chunksize``.
* **decode**: no replica of the chunk verifies; read the damaged ranges
  of the healthiest ``d`` other chunks (``HealthScoreboard.order``),
  rebuild them through a per-call ``ReconstructBatcher`` (concurrent
  ranges coalesce into one ``[B, d, S]`` dispatch), splice, rewrite in
  place.  For ``pm-msr`` parts the ranges are whole chunks (byte t of a
  stripe is not byte t of one codeword).
* **fallback**: anything the planner cannot finish in place goes back
  to the caller for the classic full ``resilver``.

On a ``cuda`` cluster the decode dispatches, the msr projections and
combine and the fallback resilver all run the GF(2^8) kernel (K1) on
the card; there is no host fallback.

**Byte metering.**  Every byte the planner touches (victim re-reads,
helper reads, repair writes) is charged to the caller's token bucket
(``cluster/scrub.py``) BEFORE the I/O.  The counters carry the part's
``code`` (a closed set) and feed the ``cb_repair_*`` families through
the process registry, ``/scrub/status`` and the profiler stanza.

**End-to-end safety.**  A rebuilt chunk is written back only after its
FULL content hash verifies.  Repair writes are in-place overwrites of
content-addressed chunks, so the planner never touches metadata.  The
per-call batcher is drained before ``repair_part`` returns.
"""

from __future__ import annotations

import asyncio
import threading
from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

import numpy as np

from chunky_bits_tpu_torch.cluster import clock as _clock
from chunky_bits_tpu_torch.cluster.health import location_key
from chunky_bits_tpu_torch.errors import ErasureError, LocationError
from chunky_bits_tpu_torch.ops.backend import KNOWN_CODES
from chunky_bits_tpu_torch.file.location import (
    OVERWRITE,
    Location,
    LocationContext,
    Range,
)
from chunky_bits_tpu_torch.utils import aio

if TYPE_CHECKING:  # typing-only: avoid import cycles at runtime
    from chunky_bits_tpu_torch.file.chunk import Chunk
    from chunky_bits_tpu_torch.file.file_part import FilePart
    from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline

#: a chunk verdict list as collected by the scrub verify phase: one
#: ``(location, verdict)`` per replica — True verified, False corrupt,
#: None unreadable
Verdicts = list[list[tuple[Location, Optional[bool]]]]


def merge_ranges(ranges: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Union of ``(start, length)`` ranges, merged where they overlap or
    touch — the per-part read schedule when several chunks localized
    different damage."""
    if not ranges:
        return []
    ordered = sorted(ranges)
    out = [ordered[0]]
    for start, length in ordered[1:]:
        last_start, last_len = out[-1]
        if start <= last_start + last_len:
            out[-1] = (last_start,
                       max(last_len, start + length - last_start))
        else:
            out.append((start, length))
    return out


#: the per-code counter keys (one dict per code in ``RepairStats.
#: by_code`` and the planner's internals); ``plans_msr`` /
#: ``helper_bytes_msr`` stay zero for rs parts
COUNTER_KEYS = ("plans_copy", "plans_decode", "plans_msr",
                "plans_fallback", "helper_bytes_replica",
                "helper_bytes_decode", "helper_bytes_msr",
                "bytes_localized", "bytes_rebuilt", "bytes_written",
                "ranges_rebuilt", "verify_failures")

#: the closed ``code`` label set: the shipped codes, ONE
#: definition (ops/backend.py): every part the planner touches is
#: counted under one of these; a foreign/unknown code is clamped to
#: "rs" on its (only possible) fallback bump
CODES = KNOWN_CODES


@dataclass
class RepairStats:
    """Counter snapshot: the ``cb_repair_*`` families, the
    ``/scrub/status`` ``repair`` stanza and the profiler's report are
    all this one shape.  Top-level fields are cross-code
    totals; ``by_code`` carries the same keys per erasure code."""

    plans_copy: int
    plans_decode: int
    plans_msr: int
    plans_fallback: int
    helper_bytes_replica: int
    helper_bytes_decode: int
    helper_bytes_msr: int
    bytes_localized: int
    bytes_rebuilt: int
    bytes_written: int
    ranges_rebuilt: int
    verify_failures: int
    by_code: dict = None  # type: ignore[assignment]

    def helper_bytes(self) -> int:
        return (self.helper_bytes_replica + self.helper_bytes_decode
                + self.helper_bytes_msr)

    def savings_ratio(self) -> Optional[float]:
        """Helper bytes read per rebuilt byte — the headline number the
        planner exists to shrink (d for classic decode of whole chunks,
        approaching 1x for copy plans / d x damage for localized
        decode / 2x for msr regeneration).  None before any rebuild."""
        if self.bytes_rebuilt <= 0:
            return None
        return self.helper_bytes() / self.bytes_rebuilt

    def to_obj(self) -> dict:
        ratio = self.savings_ratio()
        return {
            "plans_copy": self.plans_copy,
            "plans_decode": self.plans_decode,
            "plans_msr": self.plans_msr,
            "plans_fallback": self.plans_fallback,
            "helper_bytes_replica": self.helper_bytes_replica,
            "helper_bytes_decode": self.helper_bytes_decode,
            "helper_bytes_msr": self.helper_bytes_msr,
            "bytes_localized": self.bytes_localized,
            "bytes_rebuilt": self.bytes_rebuilt,
            "bytes_written": self.bytes_written,
            "ranges_rebuilt": self.ranges_rebuilt,
            "verify_failures": self.verify_failures,
            "by_code": {code: dict(counters)
                        for code, counters in (self.by_code or {}).items()},
            **({"helper_bytes_per_rebuilt_byte": round(ratio, 4)}
               if ratio is not None else {}),
        }


@dataclass
class PartRepairOutcome:
    """What ``repair_part`` accomplished for one part."""

    repaired: int  # replicas rewritten with verified bytes
    failures: int  # victims that could not be rewritten this pass
    fallback: bool  # the part still needs the classic full resilver


class RepairPlanner:
    """One cluster's repair scheduler; see the module docstring.

    ``health`` is the cluster's ``HealthScoreboard`` (or None — helper
    choice falls back to metadata order, the reference's walk);
    ``bucket`` is the byte-rate ``TokenBucket`` repair I/O charges
    (or None — unmetered, e.g. ``--once`` CLI runs at rate 0);
    ``backend`` names the erasure backend for decode dispatches.

    ``replace_after_s`` is the **re-placement escalation threshold**: a
    victim replica whose in-place repair writes have been failing
    continuously for this long is treated as permanently gone, and its
    part is handed to the classic resilver to allocate a NEW location.
    Below the threshold the planner just retries next pass — a
    transient partition must be *waited out*, not answered with a
    republish storm that moves every partitioned chunk somewhere else
    (partitioned nodes come back with their bytes, dead disks never
    do).  Times run on the cluster clock seam (``cluster/clock.py``).
    """

    def __init__(self, health=None, bucket=None,
                 backend: Optional[str] = None,
                 replace_after_s: float = 900.0,
                 stale_after_s: Optional[float] = None) -> None:
        from chunky_bits_tpu_torch.cluster.scrub import TokenBucket

        self.health = health
        # rate 0 = take() returns immediately (scrub's documented
        # no-op), so direct planner use outside a daemon stays unmetered
        self.bucket = bucket if bucket is not None else TokenBucket(0.0)
        self.backend = backend
        self.replace_after_s = max(float(replace_after_s), 0.0)
        #: the continuity bound: a gap between failures longer than
        #: this RESETS the window below.  Defaults to replace_after_s;
        #: callers whose retry cadence is slower than the threshold
        #: (ScrubDaemon passes max(replace_after_s, 2 x pass interval))
        #: must widen it, or consecutive-pass failures would always
        #: look stale and escalation could never fire.
        self.stale_after_s = max(
            float(stale_after_s) if stale_after_s is not None else 0.0,
            self.replace_after_s)
        #: node key -> (first, last) failure times of in-place repair
        #: writes — the persistence memory the re-placement escalation
        #: reads.  Cleared by any later success; a gap between
        #: failures longer than ``stale_after_s`` RESETS the window,
        #: so a recovered node's ancient stamp can never make a future
        #: one-pass blip escalate instantly.  Bounded by node count.
        self._unwritable_since: dict[tuple[str, str],
                                     tuple[float, float]] = {}
        # counters are read by /metrics scrapes and /scrub/status
        # handlers, possibly from other threads than the repair loop's;
        # one dict per code so every family carries the code label
        self._lock = threading.Lock()
        self._counters = {code: dict.fromkeys(COUNTER_KEYS, 0)
                          for code in CODES}
        # weakly self-register with the process metrics registry so a
        # /metrics scrape reports repair progress (same pattern as the
        # scrub daemon and the health scoreboard)
        from chunky_bits_tpu_torch.obs.metrics import get_registry

        get_registry().register_source("repair", self)

    # ---- reporting ----

    def _bump(self, code: str, **deltas: int) -> None:
        counters = self._counters[code if code in self._counters
                                  else "rs"]
        with self._lock:
            for key, delta in deltas.items():
                counters[key] += delta

    def stats(self) -> RepairStats:
        with self._lock:
            by_code = {code: dict(counters)
                       for code, counters in self._counters.items()}
        totals = {key: sum(c[key] for c in by_code.values())
                  for key in COUNTER_KEYS}
        return RepairStats(by_code=by_code, **totals)

    # ---- shared plumbing ----

    def _order(self, locations: list[Location]) -> list[Location]:
        """Best-health-first (stable: a fresh scoreboard — or none —
        reproduces metadata order)."""
        if self.health is None or len(locations) < 2:
            return list(locations)
        return self.health.order(locations)

    async def _read_range(self, location: Location, start: int,
                          length: int, cx: LocationContext) -> bytes:
        """Exactly ``length`` bytes at chunk offset ``start`` from one
        replica, charged to the byte bucket BEFORE the I/O.  Short reads
        are failures — a truncated replica must not masquerade as
        content.  Replicas carrying their own range view (never the
        case for destination-written chunks) are refused so offsets
        cannot silently compose wrong."""
        if location.range.is_specified():
            raise LocationError(
                f"cannot range-read ranged replica {location}")
        await self.bucket.take(length)
        data = await location.with_range(Range(start, length)).read(cx)
        if len(data) != length:
            raise LocationError(
                f"short range read from {location}: "
                f"{len(data)} != {length}")
        return data

    async def _read_full(self, location: Location, cx: LocationContext
                         ) -> bytes:
        """A whole replica, metered (length probed first so the budget
        is charged before the transfer, like scrub verification)."""
        nbytes = await location.file_len(cx)
        await self.bucket.take(nbytes)
        return await location.read(cx)

    async def _localize(self, ci: int, chunk: "Chunk", chunksize: int,
                        corrupt: list[Location], cx: LocationContext,
                        pipe: "HostPipeline",
                        payloads: Optional[dict] = None,
                        code: str = "rs"
                        ) -> tuple[Optional[bytearray],
                                   list[tuple[int, int]]]:
        """(base bytes to splice into, damaged ranges) for one damaged
        chunk.  With a digest tree and a *readable* corrupt replica the
        damage localizes to block ranges; otherwise the whole chunk is
        the range and the base starts as zeros (every byte will be
        rewritten).  ``payloads`` maps ``(chunk index, location)`` to
        corrupt-replica bytes the caller's verify phase already read
        (the generic read path surfaces them; the fused hash path does
        not) — when present, localization costs no I/O at all.  A
        victim re-read, when needed, is metered like any repair I/O."""
        whole = [(0, chunksize)]
        if chunk.blocks is None:
            return None, whole
        for location in corrupt:
            base = (payloads or {}).get((ci, location))
            if base is None:
                try:
                    base = await self._read_full(location, cx)
                except LocationError:
                    continue
                self._bump(code, bytes_localized=len(base))
            blocks = chunk.blocks
            ranges = await pipe.run(
                "verify",
                lambda base=base: blocks.damaged_ranges(base),
                nbytes=len(base))
            if ranges:  # localized: splice into this replica's bytes
                return bytearray(base), ranges
            # None (length mismatch) or [] (raced a writer/repair —
            # the full-hash gate downstream decides): whole-chunk
            return None, whole
        return None, whole

    async def _verify_full(self, chunk: "Chunk", buf, pipe: "HostPipeline",
                           code: str = "rs") -> bool:
        """The end-to-end gate: the spliced chunk must match its
        content hash before any write."""
        ok = await pipe.run(
            "verify", lambda: chunk.hash.verify(bytes(buf)),
            nbytes=len(buf))
        if not ok:
            self._bump(code, verify_failures=1)
        return bool(ok)

    async def _write_victims(self, chunk: "Chunk", payload: bytes,
                             victims: list[Location],
                             cx: LocationContext,
                             code: str = "rs") -> tuple[int, int]:
        """Rewrite ``victims`` in place with verified bytes (metered);
        returns (repaired, failures).  Content-addressed overwrite is
        always safe — the same rationale as resilver's overwrite
        deviation."""
        overwrite_cx = cx.but_with(on_conflict=OVERWRITE)
        repaired = failures = 0
        for victim in victims:
            await self.bucket.take(len(payload))
            key = location_key(victim)
            try:
                await victim.write(payload, overwrite_cx)
            except LocationError:
                # node still down/full: counted, retried next pass —
                # and remembered, so a node that STAYS unwritable past
                # replace_after_s escalates to re-placement.  A stale
                # window (no failure observed for replace_after_s)
                # restarts at now: "continuously" means failures keep
                # recurring, not "failed once, ever"
                failures += 1
                now = _clock.monotonic()
                prev = self._unwritable_since.get(key)
                if prev is None or now - prev[1] > self.stale_after_s:
                    self._unwritable_since[key] = (now, now)
                else:
                    self._unwritable_since[key] = (prev[0], now)
                continue
            self._unwritable_since.pop(key, None)
            self._bump(code, bytes_written=len(payload))
            repaired += 1
        return repaired, failures

    # ---- the plans ----

    async def _copy_plan(self, ci: int, chunk: "Chunk", chunksize: int,
                         good: list[Location], corrupt: list[Location],
                         missing: list[Location], cx: LocationContext,
                         pipe: "HostPipeline",
                         payloads: Optional[dict] = None,
                         code: str = "rs"
                         ) -> tuple[int, int]:
        """1x repair from a healthy replica: ranged reads for localized
        corrupt victims, one whole-chunk read (cached across victims)
        for the rest.  Sources fail over best-health-first — a replica
        that verified a moment ago may be gone by repair time, and the
        next one serves the same bytes.  Returns (repaired, failures)."""
        self._bump(code, plans_copy=1)
        sources = self._order(good)
        repaired = failures = 0
        full: Optional[bytes] = None  # whole-source cache

        async def full_payload() -> Optional[bytes]:
            nonlocal full
            if full is None:
                for source in sources:
                    try:
                        data = await self._read_full(source, cx)
                    except LocationError:
                        continue  # replica vanished: next-best source
                    self._bump(code, helper_bytes_replica=len(data))
                    if not await self._verify_full(chunk, data, pipe,
                                                   code):
                        continue  # raced a writer; try another replica
                    full = data
                    break
            return full

        async def read_range_failover(start: int, length: int
                                      ) -> Optional[bytes]:
            for source in sources:
                try:
                    seg = await self._read_range(source, start, length,
                                                 cx)
                except LocationError:
                    continue
                self._bump(code, helper_bytes_replica=length)
                return seg
            return None

        for victim in corrupt:
            spliced = False
            if chunk.blocks is not None and full is None:
                base, ranges = await self._localize(
                    ci, chunk, chunksize, [victim], cx, pipe, payloads,
                    code)
                if base is not None:
                    buf, ok = bytearray(base), True
                    for start, length in ranges:
                        seg = await read_range_failover(start, length)
                        if seg is None:
                            ok = False
                            break
                        buf[start: start + length] = seg
                    if ok and await self._verify_full(chunk, buf, pipe,
                                                      code):
                        r, f = await self._write_victims(
                            chunk, bytes(buf), [victim], cx, code)
                        if r:
                            self._bump(code, bytes_rebuilt=sum(
                                ln for _s, ln in ranges),
                                ranges_rebuilt=len(ranges))
                        repaired += r
                        failures += f
                        spliced = True
            if spliced:
                continue
            payload = await full_payload()
            if payload is None:
                failures += 1
                continue
            r, f = await self._write_victims(chunk, payload, [victim],
                                             cx, code)
            if r:
                self._bump(code, bytes_rebuilt=len(payload),
                           ranges_rebuilt=1)
            repaired += r
            failures += f
        for victim in missing:
            payload = await full_payload()
            if payload is None:
                failures += 1
                continue
            r, f = await self._write_victims(chunk, payload, [victim],
                                             cx, code)
            if r:
                self._bump(code, bytes_rebuilt=len(payload),
                           ranges_rebuilt=1)
            repaired += r
            failures += f
        return repaired, failures

    async def _read_helper_range(self, ci: int, chunk: "Chunk",
                                 location: Location, start: int,
                                 length: int, cx: LocationContext,
                                 pipe: "HostPipeline",
                                 code: str = "rs") -> bytes:
        """One helper's contribution to a decode range: metered, and
        pre-checked against the helper's own block digests when the
        range aligns to its grid (a corrupt helper fails here instead
        of poisoning the decode and costing a verify_failure)."""
        data = await self._read_range(location, start, length, cx)
        if chunk.blocks is not None:
            blocks = chunk.blocks
            verdict = await pipe.run(
                "verify",
                lambda data=data: blocks.verify_range(data, start),
                nbytes=length)
            if verdict is False:
                if self.health is not None:
                    self.health.record(location, False)
                raise LocationError(
                    f"helper block digest mismatch at {location}")
        self._bump(code, helper_bytes_decode=length)
        return data

    async def _decode_ranges(self, part: "FilePart",
                             helpers: list[tuple[int, Location]],
                             ranges: list[tuple[int, int]],
                             cx: LocationContext, pipe: "HostPipeline",
                             batcher) -> Optional[dict[int, dict]]:
        """Read each range from ``d`` healthy helpers and rebuild every
        absent chunk's bytes for it through the reconstruct batcher
        (ranges run concurrently, so same-shape rebuilds coalesce into
        one [B, d, S] dispatch).  Returns {range_start: {ci: bytes}}
        for the rebuilt (non-helper) chunk indices, or None when any
        range cannot gather ``d`` helpers."""
        chunks = part.all_chunks()
        d, p = len(part.data), len(part.parity)
        code = part.code

        async def one(start: int, length: int) -> Optional[tuple]:
            slots: list = [None] * (d + p)
            got = 0
            for ci, location in helpers:
                if got >= d:
                    break
                try:
                    data = await self._read_helper_range(
                        ci, chunks[ci], location, start, length, cx,
                        pipe, code)
                except LocationError:
                    continue
                slots[ci] = np.frombuffer(data, dtype=np.uint8)
                got += 1
            if got < d:
                return None  # not enough live helpers for this range
            arrays = await batcher.reconstruct(d, p, slots,
                                               data_only=False,
                                               code=code)
            rebuilt = {
                ci: np.ascontiguousarray(arr).tobytes()
                for ci, arr in enumerate(arrays)
                if slots[ci] is None and arr is not None
            }
            return (start, rebuilt)

        results = await aio.gather_or_cancel(
            [one(start, length) for start, length in ranges])
        if any(res is None for res in results):
            return None
        return {start: rebuilt for start, rebuilt in results}

    async def _helper_projection(self, ci: int, chunk: "Chunk",
                                 locations: list[Location], coder,
                                 chunksize: int, cx: LocationContext,
                                 pipe: "HostPipeline"
                                 ) -> Optional[np.ndarray]:
        """One helper's β-sized contribution to regenerating chunk
        ``ci``: read a verified replica and project its α stripes
        through ``φ_ci`` on the shared HostPipeline — the node-side
        compute of a real MSR deployment, where only the projection
        crosses the network.  The scrub bucket is charged the FULL
        replica read BEFORE the I/O: the byte-rate bound exists to
        protect foreground traffic on the disks this process actually
        touches, and computing a local projection reads chunksize even
        though only β enters the repair plane (``helper_bytes_msr``
        records β — the network bytes a distributed deployment would
        move — while the bucket meters the disk).  Failing/corrupt
        replicas fail over best-health-first; corrupt content demerits
        the serving node.  Returns the ``[β]`` projection, or None when
        no replica verifies (the caller drops this helper)."""
        for location in locations:
            await self.bucket.take(chunksize)
            try:
                data = await location.read(cx)
            except LocationError:
                continue
            if len(data) != chunksize:
                continue  # truncated replica cannot project soundly
            ok = await pipe.run(
                "verify", lambda data=data: chunk.hash.verify(data),
                nbytes=len(data))
            if not ok:
                # a lying helper would survive to the end-to-end gate
                # anyway, but catching it here costs one hash and saves
                # the whole plan
                if self.health is not None:
                    self.health.record(location, False)
                continue
            arr = np.frombuffer(data, dtype=np.uint8)[None, :]
            return await pipe.run(
                "encode",
                lambda arr=arr: coder.project_batch(ci, arr)[0],
                nbytes=chunksize)
        return None

    async def _msr_plan(self, part: "FilePart", ci: int,
                        chunks: list["Chunk"], good: list[list[Location]],
                        victims: list[Location], cx: LocationContext,
                        pipe: "HostPipeline"
                        ) -> Optional[tuple[int, int]]:
        """Regenerate the single lost chunk ``ci`` of a ``pm-msr`` part
        from ``d' = 2(d-1)`` helper projections (module docstring, plan
        kind **msr**): ``d'·β = 2·chunksize`` repair-plane bytes
        instead of the decode plan's ``d·chunksize``.  Helpers are the
        healthiest chunks with verified local/slab replicas; the
        rebuilt chunk passes the full content-hash gate before any
        write.  Returns (repaired, failures), or None when the plan
        cannot run/finish — the caller falls through to the classic
        decode plan, so an aborted msr attempt costs at most a few β
        reads, never correctness."""
        from chunky_bits_tpu_torch.ops.backend import get_coder

        try:
            coder = await asyncio.to_thread(
                get_coder, len(part.data), len(part.parity),
                self.backend, "pm-msr")
        except ErasureError:
            return None  # geometry this code cannot run (foreign ref)
        if part.chunksize <= 0 or part.chunksize % coder.alpha:
            return None
        beta = part.chunksize // coder.alpha
        candidates: list[tuple[int, list[Location]]] = []
        for hi in range(len(chunks)):
            if hi == ci or not good[hi]:
                continue
            locs = [loc for loc in self._order(good[hi])
                    if loc.is_local() or loc.is_slab() or loc.is_sim()]
            if locs:
                candidates.append((hi, locs))
        if len(candidates) < coder.helpers:
            return None
        # healthiest-first helper order: rank each candidate chunk by
        # its best replica through the scoreboard (same shape as the
        # decode plan's helper ordering)
        by_loc = {id(locs[0]): (hi, locs) for hi, locs in candidates}
        ordered = [by_loc[id(loc)] for loc in
                   self._order([locs[0] for _hi, locs in candidates])]
        used: list[int] = []
        projections: list[np.ndarray] = []
        for hi, locs in ordered:
            if len(used) >= coder.helpers:
                break
            proj = await self._helper_projection(
                ci, chunks[hi], locs, coder, part.chunksize, cx, pipe)
            if proj is None:
                continue
            used.append(hi)
            projections.append(proj)
            self._bump("pm-msr", helper_bytes_msr=beta)
        if len(used) < coder.helpers:
            return None  # helpers vanished since verify: decode decides
        stacked = np.ascontiguousarray(np.stack(projections))[None, ...]
        try:
            rebuilt = await pipe.run(
                "encode",
                lambda: coder.repair_batch(ci, used, stacked)[0],
                nbytes=part.chunksize)
        except ErasureError:
            return None
        payload = np.ascontiguousarray(rebuilt).tobytes()
        if not await self._verify_full(chunks[ci], payload, pipe,
                                       "pm-msr"):
            # helpers inconsistent with this chunk's hash (stale ref,
            # raced writer): the decode plan re-reads and decides
            return None
        self._bump("pm-msr", plans_msr=1)
        r, f = await self._write_victims(chunks[ci], payload, victims,
                                         cx, "pm-msr")
        if r:
            self._bump("pm-msr", bytes_rebuilt=part.chunksize,
                       ranges_rebuilt=1)
        return (r, f)

    def _maybe_replace(self, code: str, chunks: list,
                       corrupt: list, missing: list,
                       fallback: bool) -> bool:
        """The re-placement escalation (see the class docstring): when
        any victim of this part has been unwritable continuously for
        ``replace_after_s``, hand the part to the classic resilver so
        the replica gets a NEW home.  Never fires for nodes that came
        back (success pops the memory) and never below the threshold —
        a transient partition is waited out in place.  The key stays
        after firing (every part with a replica on the dead node must
        escalate, and they arrive one repair_part call at a time);
        staleness is handled on the RECORDING side: a gap between
        failures longer than the threshold resets the window, so the
        entry can never act as a "failed once, ever" stamp."""
        if fallback or self.replace_after_s <= 0 \
                or not self._unwritable_since:
            return fallback
        now = _clock.monotonic()
        for ci in range(len(chunks)):
            for loc in corrupt[ci] + missing[ci]:
                window = self._unwritable_since.get(location_key(loc))
                if (window is not None
                        and now - window[0] >= self.replace_after_s
                        # the streak must still be live: a window whose
                        # last failure is older than the continuity
                        # bound is stale evidence, not a
                        # continuously-dead node
                        and now - window[1] <= self.stale_after_s):
                    self._bump(code, plans_fallback=1)
                    return True
        return fallback

    # ---- the entry point ----

    async def repair_part(self, part: "FilePart", verdicts: Verdicts,
                          cx: LocationContext, pipe: "HostPipeline",
                          payloads: Optional[dict] = None
                          ) -> PartRepairOutcome:
        """Repair one part in place from the scrub verify phase's
        replica verdicts.  Copy plans run first (they may restore a
        replica a decode plan would otherwise have to route around);
        then every chunk with NO verified replica is rebuilt from
        ranged reads off the healthiest ``d`` helpers.  Anything the
        planner cannot finish in place is reported as ``fallback`` for
        the classic full resilver.  ``payloads`` optionally carries
        corrupt-replica bytes the verify phase already surfaced, keyed
        ``(chunk index, location)`` — localization then re-reads
        nothing (see :meth:`_localize`)."""
        chunks = part.all_chunks()
        d = len(part.data)
        code = part.code
        repaired = failures = 0
        fallback = False

        if code not in KNOWN_CODES:
            # a part declaring a code this build does not implement:
            # even copy plans stay hands-off (the bytes' semantics are
            # a newer writer's) — hand it straight to resilver, whose
            # own require_known_code reports it cleanly.  Counted under
            # the clamped "rs" label (the closed-set rule).
            self._bump("rs", plans_fallback=1)
            return PartRepairOutcome(repaired, failures, True)

        good: list[list[Location]] = []
        corrupt: list[list[Location]] = []
        missing: list[list[Location]] = []
        for per_loc in verdicts:
            good.append([loc for loc, v in per_loc if v is True])
            corrupt.append([loc for loc, v in per_loc if v is False])
            missing.append([loc for loc, v in per_loc if v is None])

        if any(not chunk.locations for chunk in chunks):
            # a chunk with no replicas at all needs NEW placement —
            # resilver's job (get_used_writers), not an in-place plan
            fallback = True
            self._bump(code, plans_fallback=1)

        # 1. copy plans: damaged replicas beside a healthy one
        for ci, chunk in enumerate(chunks):
            if good[ci] and (corrupt[ci] or missing[ci]):
                r, f = await self._copy_plan(
                    ci, chunk, part.chunksize, good[ci], corrupt[ci],
                    missing[ci], cx, pipe, payloads, code)
                repaired += r
                failures += f

        # 2. chunks with no verified replica anywhere
        lost = [ci for ci in range(len(chunks))
                if not good[ci] and (corrupt[ci] or missing[ci])]
        if not lost:
            fallback = self._maybe_replace(code, chunks, corrupt,
                                           missing, fallback)
            return PartRepairOutcome(repaired, failures, fallback)

        # 2a. msr regeneration: a pm-msr part that lost exactly ONE
        # chunk rebuilds from d' β-sized helper projections (2x
        # chunksize of repair-plane bytes instead of decode's d x);
        # any shortfall falls through to the decode plan below
        if code == "pm-msr" and len(lost) == 1:
            res = await self._msr_plan(
                part, lost[0], chunks, good,
                corrupt[lost[0]] + missing[lost[0]], cx, pipe)
            if res is not None:
                repaired += res[0]
                failures += res[1]
                fallback = self._maybe_replace(code, chunks, corrupt,
                                               missing, fallback)
                return PartRepairOutcome(repaired, failures, fallback)

        # 2b. decode plans
        helper_pool = [(ci, self._order(good[ci])[0])
                       for ci in range(len(chunks)) if good[ci]]
        if len(helper_pool) < d:
            # unrecoverable in place AND by resilver; hand it back so
            # the classic path reports it (legacy failure accounting)
            self._bump(code, plans_fallback=1)
            return PartRepairOutcome(repaired, failures, True)
        # healthiest-first helper order: sort the candidate locations
        # through the scoreboard, then map back to (chunk, location)
        by_loc = {id(loc): (ci, loc) for ci, loc in helper_pool}
        helpers = [by_loc[id(loc)] for loc in
                   self._order([loc for _ci, loc in helper_pool])]

        self._bump(code, plans_decode=1)
        bases: dict[int, Optional[bytearray]] = {}
        ranges_by_ci: dict[int, list[tuple[int, int]]] = {}
        for ci in lost:
            if code == "pm-msr":
                # stripe-structured code: byte t of the chunk is not
                # byte t of one codeword, so decode works at whole-chunk
                # granularity (block trees still localize COPY plans)
                bases[ci] = None
                ranges_by_ci[ci] = [(0, part.chunksize)]
                continue
            base, ranges = await self._localize(
                ci, chunks[ci], part.chunksize, corrupt[ci], cx, pipe,
                payloads, code)
            bases[ci] = base
            ranges_by_ci[ci] = ranges
        union = merge_ranges(
            [r for ranges in ranges_by_ci.values() for r in ranges])

        from chunky_bits_tpu_torch.ops.batching import ReconstructBatcher

        batcher = ReconstructBatcher(backend=self.backend)
        try:
            rebuilt = await self._decode_ranges(
                part, helpers, union, cx, pipe, batcher)
        except ErasureError:
            # a geometry/shape the codec refuses (e.g. a handcrafted
            # pm-msr ref whose geometry the code cannot run): the
            # classic resilver reports it in its own words
            rebuilt = None
        finally:
            await batcher.aclose()
        if rebuilt is None:
            self._bump(code, plans_fallback=1)
            return PartRepairOutcome(repaired, failures, True)

        for ci in lost:
            base = bases[ci]
            buf = (bytearray(part.chunksize) if base is None
                   else bytearray(base))
            spliced = 0
            for start, length in union:
                seg = rebuilt.get(start, {}).get(ci)
                if seg is None or len(seg) != length:
                    spliced = -1
                    break
                buf[start: start + length] = seg
                spliced += 1
            if spliced < 0 or not await self._verify_full(
                    chunks[ci], buf, pipe, code):
                # helpers inconsistent with this chunk's hash (stale
                # tree, raced writer): the full resilver re-reads
                # everything and decides
                fallback = True
                self._bump(code, plans_fallback=1)
                continue
            victims = corrupt[ci] + missing[ci]
            if not victims:
                fallback = True  # needs NEW placement: resilver's job
                self._bump(code, plans_fallback=1)
                continue
            r, f = await self._write_victims(chunks[ci], bytes(buf),
                                             victims, cx, code)
            if r:
                self._bump(
                    code,
                    bytes_rebuilt=sum(ln for _s, ln in
                                      ranges_by_ci[ci]),
                    ranges_rebuilt=len(ranges_by_ci[ci]))
            repaired += r
            failures += f
        fallback = self._maybe_replace(code, chunks, corrupt, missing,
                                       fallback)
        return PartRepairOutcome(repaired, failures, fallback)
