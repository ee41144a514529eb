"""The erasure-coding stripe: ``d`` data + ``p`` parity chunks (the port of
``chunky_bits_tpu/file/file_part.py``).

Mirrors the reference's ``FilePart`` (src/file/file_part.rs:57-65) and its
four per-part algorithms: read (+decode) (:73-135), encode (+write)
(:137-226), verify (:228-251), resilver (:253-389), plus the Integrity
lattice (:392-455) and the Verify/Resilver part reports (:570-838).  The
erasure math goes through the port's ``ErasureCoder``; ``encode_shards`` is
pure, so a staging layer can batch many parts into one device dispatch.

Verify hashes a local or slab replica in one native read+hash pass
(``_hash_local_fused``, the SHA-NI engine of csrc/gf256.cpp), as the JAX
package does, and re-reads anything else and hashes it on the host
pipeline; both give the same digests.
"""

from __future__ import annotations

import asyncio
import enum
import random
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Any, Iterator, Optional

import numpy as np

from chunky_bits_tpu_torch.errors import (
    FileReadError,
    FileWriteError,
    LocationError,
    NotEnoughChunks,
    ShardError,
    is_transient_error,
)
from chunky_bits_tpu_torch.file.chunk import Chunk
from chunky_bits_tpu_torch.file.hashing import AnyHash, Sha256Hash
from chunky_bits_tpu_torch.file.location import (Location, LocationContext,
                                                 default_context)
from chunky_bits_tpu_torch.obs import tracing as obs_tracing
from chunky_bits_tpu_torch.ops import ErasureCoder, get_coder
from chunky_bits_tpu_torch.utils import aio
from chunky_bits_tpu_torch.utils import clock as _clock

if TYPE_CHECKING:  # typing-only: none of these is needed at import time
    from chunky_bits_tpu_torch.file.collection_destination import (
        CollectionDestination,
    )
    from chunky_bits_tpu_torch.file.chunk_cache import ChunkCache
    from chunky_bits_tpu_torch.ops.batching import ReconstructBatcher
    from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline

#: buffer-protocol payloads the codec surfaces accept (numpy rows are
#: normalized to memoryview at the boundaries that take them)
BufferLike = bytes | bytearray | memoryview


class LocationIntegrity(enum.IntEnum):
    """Ordered: lower is better (src/file/file_part.rs:397-423)."""

    VALID = 0
    RESILVERED = 1
    INVALID = 2
    UNAVAILABLE = 3

    def is_ideal(self) -> bool:
        return self in (LocationIntegrity.VALID, LocationIntegrity.RESILVERED)

    def is_available(self) -> bool:
        return self.is_ideal()

    def __str__(self) -> str:
        return self.name.capitalize()


class FileIntegrity(enum.IntEnum):
    """Ordered: higher is worse (src/file/file_part.rs:425-455)."""

    VALID = 0
    RESILVERED = 1
    DEGRADED = 2
    UNAVAILABLE = 3

    def is_ideal(self) -> bool:
        return self in (FileIntegrity.VALID, FileIntegrity.RESILVERED)

    def is_available(self) -> bool:
        return self != FileIntegrity.UNAVAILABLE

    def __str__(self) -> str:
        return self.name.capitalize()


def _pipe(pipeline: Optional["HostPipeline"] = None) -> "HostPipeline":
    """The host compute executor for this call: the injected one
    (verify/resilver fan-outs share a single instance; sweeps pin N) or
    the process-shared pipeline.  Hash verification hops here instead of
    ``asyncio.to_thread`` so every host path draws from the same bounded
    ``min(N, nproc)`` daemon worker set and shows up in the profiler's
    per-stage counters."""
    if pipeline is not None:
        return pipeline
    from chunky_bits_tpu_torch.parallel.host_pipeline import \
        get_host_pipeline

    return get_host_pipeline()


def _buf_len(data: object) -> int:
    try:
        return len(memoryview(data))  # type: ignore[arg-type]
    except TypeError:
        return 0


#: whether the native read+hash pass is available, resolved at first use
_FUSED_OK: Optional[bool] = None


async def _hash_local_fused(chunk: Chunk, location: Location,
                            cx: LocationContext,
                            pipeline: Optional["HostPipeline"] = None
                            ) -> Optional[bytes]:
    """Digest of a local or slab-packed chunk from the native streaming
    read+hash pass (``ops.cpu_backend.sha256_file``), the bytes never
    reaching Python; a slab extent hashes in place as
    ``sha256_file(slab file, extent offset + start, length)``.  None when
    the pass does not apply: an http or zero-extended location, a hash
    other than sha256, an attached profiler (which must see the generic
    read), a host whose row hasher is not the native engine
    (``ops.backend.row_hasher_engine``), or any I/O error (the generic
    path re-reads and reports it in its own words)."""
    if (cx.profiler is not None
            or not (location.is_local() or location.is_slab())
            or location.range.extend_zeros
            or chunk.hash.algorithm != "sha256"):
        return None
    global _FUSED_OK
    if _FUSED_OK is None:
        from chunky_bits_tpu_torch.ops.backend import row_hasher_engine

        # the first call may build the codec: off the loop
        _FUSED_OK = await asyncio.to_thread(row_hasher_engine) == "native"
    if not _FUSED_OK:
        return None
    from chunky_bits_tpu_torch.ops.cpu_backend import sha256_file

    path = location.target
    start = location.range.start or 0
    length = location.range.length
    if location.is_slab():
        ext = await asyncio.to_thread(location.slab_extent)
        if ext is None:
            return None  # the generic path reports the miss
        path, base, ext_len = ext
        avail = max(ext_len - start, 0)
        if length is None:
            length = avail
        elif length > avail:
            # a short range reads short on the generic path; the fused
            # pass must not hash past the extent into a neighbour
            return None
        start += base
    try:
        return await _pipe(pipeline).run(
            "verify", lambda: sha256_file(path, start, length),
            nbytes=length or 0)
    except OSError:
        return None


async def _read_chunk_payload(location: Location, cx: LocationContext
                              ) -> bytes | memoryview:
    """Chunk bytes for the read/resilver paths: a zero-copy page-cache
    view for local chunks (``Location.read_view`` — hash verification,
    RS reconstruction, and shard re-writes all consume buffers), else
    the generic read."""
    view = await location.read_view(cx)
    if view is not None:
        return view
    return await location.read(cx)


async def _reconstruct(arrays: list[Optional[np.ndarray]], d: int, p: int,
                       coder: Optional[ErasureCoder], backend: Optional[str],
                       batcher: Optional[ReconstructBatcher],
                       data_only: bool,
                       code: str = "rs") -> list[Optional[np.ndarray]]:
    """Fill the ``None`` rows of ``arrays``: through the shared batcher
    when one is wired in (coalesced device dispatches), else via a lazily
    resolved coder off-loop: building a device backend compiles its
    kernels at first use, which must neither block the event loop nor run
    on healthy reads.  ``code`` is the part's wire-format erasure code;
    an injected ``coder`` must already match it (the write path injects
    its own)."""
    if batcher is not None:
        return await batcher.reconstruct(d, p, arrays, data_only=data_only,
                                         code=code)
    if coder is None:
        coder = await asyncio.to_thread(get_coder, d, p, backend, code)
    fn = coder.reconstruct_data if data_only else coder.reconstruct
    return await asyncio.to_thread(fn, arrays)


def split_into_shards(data_buf: BufferLike, length: int, d: int,
                      shard_len: Optional[int] = None
                      ) -> tuple[list[memoryview], int]:
    """Split ``length`` meaningful bytes (backed by a zero-padded buffer)
    into d equal shards of ceil(length/d) bytes — the reference's round-up
    split (src/file/file_part.rs:150-158).  Returns (shards, shard_len).

    ``shard_len`` overrides the default round-up (sub-symbol codes round
    further so each shard divides into equal stripes; the extra tail is
    zero-padded exactly like the classic split's)."""
    buf_length = (shard_len if shard_len is not None
                  else (length + d - 1) // d if length > 0 else 0)
    view = memoryview(data_buf)
    if len(view) < buf_length * d:
        padded = bytearray(buf_length * d)
        padded[: len(view)] = view
        view = memoryview(padded)
    shards = [view[buf_length * i: buf_length * (i + 1)] for i in range(d)]
    return shards, buf_length


@dataclass
class FilePart:
    chunksize: int
    data: list[Chunk]
    parity: list[Chunk] = field(default_factory=list)
    encryption: Optional[str] = None
    #: erasure code of this part's stripe — "rs" (classic Reed-Solomon,
    #: the only value old references carry; the key is omitted on the
    #: wire so rs refs stay byte-identical to pre-code writers) or
    #: "pm-msr" (ops/pm_msr.py).  Values outside ops.backend.KNOWN_CODES
    #: parse fine but degrade every codec-touching operation (read,
    #: resilver, repair) to a clean FileReadError — a foreign code could
    #: be non-systematic, so even a healthy read must refuse to guess.
    code: str = "rs"

    def len_bytes(self) -> int:
        return self.chunksize * len(self.data)

    # ---- serde (wire-compatible with the reference YAML/JSON) ----

    def to_obj(self) -> dict:
        obj: dict = {}
        if self.encryption is not None:
            obj["encryption"] = self.encryption
        if self.code != "rs":
            # strictly additive: rs parts serialize without the key,
            # byte-identical to references written before this field
            obj["code"] = self.code
        obj["chunksize"] = self.chunksize
        obj["data"] = [c.to_obj() for c in self.data]
        if self.parity:
            obj["parity"] = [c.to_obj() for c in self.parity]
        return obj

    @classmethod
    def from_obj(cls, obj: dict) -> "FilePart":
        return cls(
            chunksize=int(obj["chunksize"]),
            data=[Chunk.from_obj(c) for c in obj["data"]],
            parity=[Chunk.from_obj(c) for c in obj.get("parity", [])],
            encryption=obj.get("encryption"),
            # an explicit ``code: null`` means unset, like an absent
            # key — never the string "None" (which would brick reads)
            code=str(obj.get("code") or "rs"),
        )

    def require_known_code(self) -> None:
        """Raise the clean per-part gate for codec-touching paths: a
        part declaring a code this reader does not implement must fail
        as a read error (the CLI and gateway report it per file), never
        crash or silently concatenate chunks of unknown semantics."""
        from chunky_bits_tpu_torch.ops.backend import KNOWN_CODES

        if self.code not in KNOWN_CODES:
            raise FileReadError(
                f"part uses unknown erasure code {self.code!r} "
                f"(this reader knows {', '.join(KNOWN_CODES)}; "
                f"a newer writer produced this reference)")

    def all_chunks(self) -> list[Chunk]:
        return list(self.data) + list(self.parity)

    # ---- read + decode (src/file/file_part.rs:73-135) ----

    async def read(self, cx: Optional[LocationContext] = None,
                   coder: Optional[ErasureCoder] = None,
                   backend: Optional[str] = None,
                   batcher: Optional[ReconstructBatcher] = None,
                   cache: Optional[ChunkCache] = None,
                   pipeline: Optional[HostPipeline] = None) -> bytes:
        """``read_buffers`` joined into one bytes object (padding
        included; the file reader trims)."""
        return b"".join(
            await self.read_buffers(cx, coder, backend, batcher, cache,
                                    pipeline))

    async def read_buffers(self, cx: Optional[LocationContext] = None,
                           coder: Optional[ErasureCoder] = None,
                           backend: Optional[str] = None,
                           batcher: Optional[ReconstructBatcher] = None,
                           cache: Optional[ChunkCache] = None,
                           pipeline: Optional[HostPipeline] = None) -> list:
        """Scattered read: d workers randomly grab chunks from the shared
        d+p pool, falling through each chunk's locations in order;
        RS-reconstruct if any data chunk is missing.  Returns the d
        data-chunk buffers in order (bytes or zero-copy page-cache views,
        d*chunksize in all, padding included) without joining them.

        ``batcher`` (an ops.batching.ReconstructBatcher) coalesces this
        part's reconstruction with other parts in flight into one device
        dispatch.

        ``cache`` (a file.chunk_cache.ChunkCache) short-circuits fetch
        and verify for chunks whose verified bytes it holds: hits fill
        their slots before any worker starts, misses fetch through the
        cache's single flight (concurrent readers of one digest share
        one fetch), and only whole verified buffers are inserted.

        In a cluster (``cx.health`` set, cluster/health.py) every fetch
        reports to the location-health scoreboard, and with the
        ``hedge_ms`` tunable above 0 the read is tail-tolerant: a chunk's
        locations are tried best-health first and raced after the
        adaptive hedge delay (``fetch_hedged``), and a straggling chunk
        is beaten by fetching one more and reconstructing
        (``straggler_race``).  Transient HTTP errors get ``read_retries``
        retries per location."""
        self.require_known_code()
        cx = cx or default_context()
        pipe = _pipe(pipeline)
        if cx.profiler is not None:
            # read-side verification runs on the host pipeline, so its
            # per-stage counters belong in the report
            cx.profiler.attach_pipeline(pipe)
        if cache is not None and cx.profiler is not None:
            # a cache hit logs no read entry, so the profiler shows the
            # cache's own counters instead
            cx.profiler.attach_cache(cache)
        # the cluster's scoreboard, or None outside a cluster; with
        # hedging off the locations are walked in metadata order
        health = cx.health
        hedging = health is not None and health.hedge_enabled
        if health is not None and cx.profiler is not None:
            cx.profiler.attach_health(health)
        d, p = len(self.data), len(self.parity)
        # slot payloads are bytes, zero-copy memoryviews or rebuilt array
        # views (the consumers take buffers)
        slots: list = [None] * (d + p)
        pool: list[tuple[int, Chunk]] = []
        for index, chunk in enumerate(self.all_chunks()):
            buf = (cache.get(chunk.cache_key())
                   if cache is not None and chunk.cache_key() is not None
                   else None)
            if buf is not None:
                slots[index] = buf
            else:
                pool.append((index, chunk))
        pool_lock = asyncio.Lock()

        async def read_verified(chunk: Chunk, location: Location
                                ) -> tuple[bool, object]:
            """(hash_ok, data), a local chunk mapped and verified in ONE
            worker-thread hop: per-chunk hop latency, not bytes, dominates
            warm local reads."""
            mapper = location.read_view_mapper(cx)
            if mapper is not None:
                def mapped_and_verified() -> Optional[tuple[bool, object]]:
                    data = mapper()
                    if data is None:
                        return None  # unmappable: generic path below
                    return (chunk.hash.verify(data), data)

                # chunks at or under the pipeline's inline bound map and
                # verify on the loop: lockstep completion lets concurrent
                # degraded parts coalesce their reconstructs
                fused = await pipe.run(
                    "verify", mapped_and_verified,
                    nbytes=location.range.length or self.chunksize)
                if fused is not None:
                    return fused
                # the mapper's None is deterministic: straight to the
                # generic read
                data = await location.read(cx)
            else:
                data = await _read_chunk_payload(location, cx)
            ok = await pipe.run(
                "verify", lambda data=data: chunk.hash.verify(data),
                nbytes=_buf_len(data))
            return (ok, data)

        async def read_one(chunk: Chunk, location: Location
                           ) -> tuple[bool, object]:
            """``read_verified`` plus up to ``cx.read_retries`` jittered
            retries against the same location for transient HTTP errors
            (the reference never retries, src/file/file_part.rs:83-101)."""
            attempt = 0
            while True:
                try:
                    return await read_verified(chunk, location)
                except LocationError as err:
                    if attempt >= cx.read_retries \
                            or not is_transient_error(err):
                        raise
                    attempt += 1
                    await _clock.sleep(
                        random.uniform(0.025, 0.075) * attempt)

        def _corrupt(failures: list, location: Location,
                     chunk: Chunk) -> None:
            failures.append((location, f"hash mismatch (corrupt chunk "
                                       f"{chunk.hash})"))
            if health is not None:
                # the I/O hook recorded a good transfer; corrupt content
                # is still a demerit for the node that served it
                health.record(location, False)

        async def fetch_serial(chunk: Chunk, failures: list
                               ) -> Optional[object]:
            for location in chunk.locations:
                try:
                    ok, data = await read_one(chunk, location)
                except LocationError as err:
                    failures.append((location, str(err)))
                    continue
                if ok:
                    return data
                _corrupt(failures, location, chunk)
            return None

        async def fetch_hedged(chunk: Chunk, failures: list
                               ) -> Optional[object]:
            """Tail-tolerant fetch ("The Tail at Scale"): fire the
            best-health location, and each time the adaptive hedge delay
            expires with the race undecided, and the budget allows, race
            the next-best one.  The first verified buffer wins; losers
            are cancelled and awaited.  A failed racer falls through to
            the next location at once, costing no hedge token."""
            locs = health.order(chunk.locations)
            pending: dict[asyncio.Task,
                          tuple[Location, bool, float]] = {}
            next_i = 0

            def spawn(is_hedge: bool) -> None:
                nonlocal next_i
                location = locs[next_i]
                next_i += 1
                task = asyncio.ensure_future(read_one(chunk, location))
                pending[task] = (location, is_hedge, _clock.monotonic())

            spawn(is_hedge=False)
            try:
                hedge_more = True
                while pending:
                    timeout = (health.hedge_delay()
                               if hedge_more and next_i < len(locs)
                               and health.hedge_allowed()
                               else None)
                    # bounded by the hedge delay, or by the racers' own
                    # location timeouts (the serial walk's bound)
                    # lint: unbounded-await-ok bounded by construction:
                    # either the hedge delay, or the racers' own
                    # network/location timeouts (the same bound the
                    # serial location walk has always had)
                    done, _ = await asyncio.wait(
                        set(pending), timeout=timeout,
                        return_when=asyncio.FIRST_COMPLETED)
                    if not done:
                        if health.try_fire_hedge():
                            spawn(is_hedge=True)
                        else:
                            # budget dry: wait out the attempts in flight
                            hedge_more = False
                        continue
                    for task in done:
                        location, is_hedge, _t0 = pending.pop(task)
                        try:
                            ok, data = task.result()
                        except LocationError as err:
                            failures.append((location, str(err)))
                            continue
                        if ok:
                            if is_hedge:
                                health.hedge_won()
                            return data
                        _corrupt(failures, location, chunk)
                    if not pending and next_i < len(locs):
                        # every racer failed: a plain fall-through
                        spawn(is_hedge=False)
                return None
            finally:
                if pending:
                    # only hedges count as cancelled hedges: a slow
                    # primary beaten by its hedge is a hedge win
                    health.hedge_cancelled(
                        sum(1 for _l, is_h, _t in pending.values()
                            if is_h))
                    now = _clock.monotonic()
                    for task, (location, _h, t0) in pending.items():
                        task.cancel()
                        # a cancelled loser ran at least this long: a
                        # lower-bound sample, so the scoreboard learns
                        # the straggler and demotes it
                        health.record_latency_floor(location, now - t0)
                    await asyncio.gather(*pending, return_exceptions=True)

        async def fetch_chunk(chunk: Chunk) -> Optional[object]:
            """First verified buffer across the chunk's locations
            (health-ranked and hedged when armed), or None when every
            location is unreadable or corrupt; which location failed and
            why goes to the profiler's failure trail."""
            failures: list[tuple[Location, str]] = []
            if health is not None:
                health.note_primary()  # hedge-budget accrual
            t0 = _clock.monotonic()
            if hedging and len(chunk.locations) > 1:
                data = await fetch_hedged(chunk, failures)
            else:
                data = await fetch_serial(chunk, failures)
            obs_tracing.record_span(
                "chunk_fetch", "network", t0, _clock.monotonic() - t0,
                "ok" if data is not None else "miss")
            if failures and cx.profiler is not None:
                for location, err in failures:
                    cx.profiler.log_location_failure(location, err)
            return data

        async def worker() -> Optional[tuple[int, object]]:
            while True:
                async with pool_lock:
                    if not pool:
                        return None
                    index, chunk = pool.pop(random.randrange(len(pool)))
                key = chunk.cache_key() if cache is not None else None
                if key is not None:
                    data = await cache.get_or_fetch(
                        key, lambda c=chunk: fetch_chunk(c))
                else:
                    data = await fetch_chunk(chunk)
                if data is not None:
                    return (index, data)

        async def straggler_race(needed: int) -> None:
            """The d-of-d+p degraded-read race: run the d chunk workers,
            and whenever twice the hedge delay passes with workers still
            out (budget allowing), draw one more chunk from the pool, so
            a straggling data chunk can be beaten by fetch+reconstruct.
            Once d slots are filled the stragglers are cancelled and
            awaited; the reconstruction below fills the gaps."""
            tasks = {asyncio.ensure_future(worker())
                     for _ in range(needed)}
            extras: set = set()  # hedge-spawned workers, for counters
            try:
                hedge_more = True
                while tasks:
                    # 2x the location delay: the per-chunk race gets the
                    # first shot at a straggler
                    timeout = (2.0 * health.hedge_delay()
                               if hedge_more and pool
                               and health.hedge_allowed() else None)
                    # bounded by the hedge delay, or by the workers' own
                    # location timeouts once the pool or budget is dry
                    # lint: unbounded-await-ok bounded by construction:
                    # the hedge delay, or the workers' own per-location
                    # network timeouts once the pool/budget is dry
                    done, _ = await asyncio.wait(
                        tasks, timeout=timeout,
                        return_when=asyncio.FIRST_COMPLETED)
                    if not done:
                        if pool and health.try_fire_hedge():
                            extra = asyncio.ensure_future(worker())
                            tasks.add(extra)
                            extras.add(extra)
                        else:
                            hedge_more = False
                        continue
                    tasks -= done
                    for task in done:
                        item = task.result()
                        if item is not None:
                            slots[item[0]] = item[1]
                    if tasks and sum(
                            1 for s in slots if s is not None) >= d:
                        # any d of d+p: reconstruct beats waiting
                        break
            finally:
                # only hedge-spawned extras count as cancelled hedges
                health.hedge_cancelled(len(tasks & extras))
                for task in tasks:
                    task.cancel()
                if tasks:
                    await asyncio.gather(*tasks, return_exceptions=True)

        # cache hits already filled some slots: only the shortfall needs
        # workers (a fully hot part starts none)
        needed = max(d - sum(1 for s in slots if s is not None), 0)
        if hedging and needed > 0:
            await straggler_race(needed)
        else:
            for item in await asyncio.gather(*[worker()
                                               for _ in range(needed)]):
                if item is not None:
                    slots[item[0]] = item[1]
        if not all(slots[i] is not None for i in range(d)):
            present = sum(1 for s in slots if s is not None)
            if present < d:
                raise NotEnoughChunks(
                    f"only {present} of {d}+{p} chunks readable"
                )
            rebuilt_idx = [i for i in range(d) if slots[i] is None]
            arrays: list[Optional[np.ndarray]] = [
                np.frombuffer(s, dtype=np.uint8) if s is not None else None
                for s in slots
            ]
            t0 = _clock.monotonic()
            arrays = await _reconstruct(arrays, d, p, coder, backend,
                                        batcher, data_only=True,
                                        code=self.code)
            obs_tracing.record_span("reconstruct", "compute", t0,
                                    _clock.monotonic() - t0)
            # rebuilt rows stay buffers (memoryviews over the arrays)
            slots = [memoryview(np.ascontiguousarray(a))
                     if isinstance(a, np.ndarray) else a
                     for a in arrays]
            if cache is not None:
                # rebuilt rows were never hash-verified, so they enter
                # through the verify-then-insert gate; a repeated
                # degraded read then hits instead of decoding again
                for i in rebuilt_idx:
                    await cache.insert_verified(self.data[i].hash,
                                                slots[i])
        return [slots[i] for i in range(d)]  # type: ignore[misc]

    # ---- encode (pure compute half; no I/O) ----

    @staticmethod
    def encode_shards(coder: ErasureCoder, data_buf: BufferLike,
                      length: int
                      ) -> tuple[list[memoryview], list[np.ndarray], int]:
        """Split + parity computation (src/file/file_part.rs:150-165).
        Pure so batching layers can aggregate parts into one dispatch."""
        d = coder.data
        shards, buf_length = split_into_shards(
            data_buf, length, d, shard_len=coder.shard_len(length))
        if buf_length == 0:
            return shards, [], 0
        stacked = np.stack(
            [np.frombuffer(s, dtype=np.uint8) for s in shards]
        )[None, ...]
        parity = list(coder.encode_batch(stacked)[0])
        return shards, parity, buf_length

    # ---- encode + write (src/file/file_part.rs:137-226) ----

    @staticmethod
    async def write_with_coder(
        coder: ErasureCoder,
        destination: CollectionDestination,
        data_buf: BufferLike,
        length: int,
        precomputed: Optional[tuple] = None,
        pipeline: Optional[HostPipeline] = None,
        block_bytes: int = 0,
    ) -> "FilePart":
        """Encode one part and write all d+p shards concurrently,
        failing fast on the first shard error.

        ``precomputed`` is ``(shards, parity, buf_length)`` or
        ``(shards, parity, buf_length, digests)`` from a staging layer;
        ``digests`` (32-byte sha256 per shard, data then parity — the
        fused encode+hash output) skips re-hashing here.

        ``block_bytes`` > 0 additionally writes a per-chunk block-digest
        tree (file/chunk.py BlockDigests, the ``repair_block_bytes``
        tunable) into each chunk longer than one block, computed on the
        same host-pipeline hash stage the per-shard SHA runs on — the
        damage-localization metadata the repair planner
        (cluster/repair.py) schedules sub-chunk rebuilds from."""
        pipe = _pipe(pipeline)
        digests: Optional[list] = None
        if precomputed is not None:
            shards, parity, buf_length = precomputed[:3]
            if len(precomputed) > 3:
                digests = precomputed[3]
        else:
            shards, parity, buf_length = await pipe.run(
                "encode",
                lambda: FilePart.encode_shards(coder, data_buf, length),
                nbytes=length)
        d, p = coder.data, coder.parity
        if digests is not None and len(digests) != d + p:
            raise FileWriteError(
                f"staging layer produced {len(digests)} digests "
                f"for {d}+{p} shards")
        writers = destination.get_writers(d + p)

        async def hash_and_write(payload: Any, writer: Any,
                                 digest: Optional[bytes]) -> Chunk:
            # Zero-copy normalization: numpy rows and memoryviews flow
            # through to the writers as buffers; only exotic payloads pay
            # a bytes() copy.
            if isinstance(payload, np.ndarray):
                payload = memoryview(np.ascontiguousarray(payload))
            elif not isinstance(payload, (bytes, bytearray, memoryview)):
                payload = bytes(payload)
            if digest is not None:
                hash_ = AnyHash.sha256(Sha256Hash(digest))
            else:
                hash_ = await pipe.run(
                    "hash",
                    lambda payload=payload: AnyHash.from_buf(payload),
                    nbytes=_buf_len(payload))
            blocks = None
            if block_bytes > 0 and _buf_len(payload) > block_bytes:
                # single-block chunks carry no tree: the chunk hash
                # already localizes damage to the whole (one) block
                from chunky_bits_tpu_torch.file.chunk import BlockDigests

                blocks = await pipe.run(
                    "hash",
                    lambda payload=payload: BlockDigests.from_buf(
                        payload, block_bytes),
                    nbytes=_buf_len(payload))
            try:
                locations = await writer.write_shard(hash_, payload)
            except ShardError as err:
                raise FileWriteError(str(err)) from err
            return Chunk(hash=hash_, locations=locations, blocks=blocks)

        payloads = list(shards) + list(parity)
        pre_digests = digests if digests is not None \
            else [None] * len(payloads)
        chunks = await aio.gather_or_cancel(
            [hash_and_write(pl, w, dg)
             for pl, w, dg in zip(payloads, writers, pre_digests)])
        return FilePart(
            chunksize=buf_length,
            data=list(chunks[:d]),
            parity=list(chunks[d:]),
            code=coder.code,
        )

    # ---- verify (src/file/file_part.rs:228-251) ----

    #: concurrent location reads per part during verify; with the
    #: file-level bound (RESILVER_CONCURRENCY parts in flight) this caps
    #: total open reads at 10×10 where the reference is unbounded
    #: (every location of every chunk at once, file_part.rs:228-251)
    VERIFY_READ_CONCURRENCY = 10

    async def verify(self, cx: Optional[LocationContext] = None,
                     pipeline: Optional[HostPipeline] = None
                     ) -> "VerifyPartReport":
        cx = cx or default_context()
        pipe = _pipe(pipeline)
        if cx.profiler is not None:
            cx.profiler.attach_pipeline(pipe)
        sem = asyncio.Semaphore(self.VERIFY_READ_CONCURRENCY)

        async def check(ci: int, chunk: Chunk, li: int,
                        location: Location) -> tuple:
            async with sem:
                digest = await _hash_local_fused(chunk, location, cx, pipe)
                if digest is not None:
                    return (ci, li, digest == chunk.hash.value.digest, None)
                try:
                    data = await location.read(cx)
                except LocationError as err:
                    return (ci, li, None, str(err))
                ok = await pipe.run(
                    "verify", lambda data=data: chunk.hash.verify(data),
                    nbytes=_buf_len(data))
                return (ci, li, ok, None)

        jobs = [
            check(ci, chunk, li, location)
            for ci, chunk in enumerate(self.all_chunks())
            for li, location in enumerate(chunk.locations)
        ]
        results = await aio.gather_or_cancel(jobs)
        read_results = {(ci, li): (ok, err) for ci, li, ok, err in results}
        return VerifyPartReport(self, read_results)

    # ---- resilver (src/file/file_part.rs:253-389) ----

    async def resilver(self, destination: CollectionDestination,
                       cx: Optional[LocationContext] = None,
                       coder: Optional[ErasureCoder] = None,
                       backend: Optional[str] = None,
                       batcher: Optional[ReconstructBatcher] = None,
                       pipeline: Optional[HostPipeline] = None
                       ) -> "ResilverPartReport":
        # Deviation from the reference: repair writes always overwrite.
        # Under the default `on_conflict: ignore` tunable the reference's
        # resilver silently keeps a corrupt chunk file when the rebuilt
        # shard lands on the node already holding it (write_subfile sees the
        # file exists and skips); overwriting a content-addressed chunk with
        # bytes matching its hash is always safe.
        self.require_known_code()
        overwrite = getattr(destination, "with_conflict_overwrite", None)
        if overwrite is not None:
            destination = overwrite()
        cx = cx or destination.get_context()
        pipe = _pipe(pipeline)
        if cx.profiler is not None:
            cx.profiler.attach_pipeline(pipe)
        chunks = self.all_chunks()
        d, p = len(self.data), len(self.parity)

        async def read_chunk(chunk: Chunk) -> tuple:
            report = []
            chunk_bytes = None
            for location in chunk.locations:
                try:
                    data = await _read_chunk_payload(location, cx)
                except LocationError as err:
                    report.append((None, str(err)))
                    continue
                ok = await pipe.run(
                    "verify",
                    lambda chunk=chunk, data=data: chunk.hash.verify(data),
                    nbytes=_buf_len(data))
                if ok and chunk_bytes is None:
                    chunk_bytes = data
                report.append((ok, None))
            return chunk_bytes, report

        gathered = await asyncio.gather(*[read_chunk(c) for c in chunks])
        data_bufs: list[Optional[bytes]] = [g[0] for g in gathered]
        read_results = {
            (ci, li): res
            for ci, g in enumerate(gathered)
            for li, res in enumerate(g[1])
        }
        chunk_status = [buf is not None for buf in data_bufs]

        write_error: Optional[str] = None
        write_results: dict[int, tuple[Optional[list[Location]],
                                       Optional[str]]] = {}
        if not all(chunk_status):
            # Reconstruct every missing chunk (data and parity).
            try:
                arrays: list[Optional[np.ndarray]] = [
                    np.frombuffer(b, dtype=np.uint8) if b is not None else None
                    for b in data_bufs
                ]
                arrays = await _reconstruct(arrays, d, p, coder, backend,
                                            batcher, data_only=False,
                                            code=self.code)
                rebuilt: list[Optional[bytes]] = [
                    a.tobytes() if isinstance(a, np.ndarray) else None
                    for a in arrays
                ]
            # surfaced as the report's
            # write_error (resilver reports failures, it never crashes
            # a sweep mid-file)
            # lint: broad-except-ok surfaced as the report's
            # write_error (resilver reports failures, it never crashes
            # a sweep mid-file)
            except Exception as err:
                write_error = str(err)
                rebuilt = data_bufs
            else:
                # Request writers: existing healthy locations inform the
                # destination which nodes already hold shards
                # (src/file/file_part.rs:309-331).
                request: list[Optional[Location]] = []
                for status, chunk in zip(chunk_status, chunks):
                    if status:
                        request.extend(chunk.locations)
                    else:
                        request.append(None)
                try:
                    writers = destination.get_used_writers(request)
                # surfaced as the report's
                # write_error; read results above still stand
                # lint: broad-except-ok surfaced as the report's
                # write_error; read results above still stand
                except Exception as err:
                    write_error = str(err)
                    writers = []
                for ci, (chunk, status) in enumerate(zip(chunks,
                                                         chunk_status)):
                    if status:
                        continue
                    payload = rebuilt[ci]
                    if payload is None:
                        continue
                    if not writers:
                        write_results[ci] = (None, "no writer available")
                        continue
                    # Take writers from the head of the stagger chain —
                    # popping the tail (as the reference does,
                    # file_part.rs:341) makes every sequential repair wait
                    # out the full 100 ms stagger timeout.
                    writer = writers.pop(0)
                    try:
                        locations = await writer.write_shard(
                            chunk.hash, payload)
                    except ShardError as err:
                        write_results[ci] = (None, str(err))
                    else:
                        chunk.locations.extend(locations)
                        write_results[ci] = (list(locations), None)
        return ResilverPartReport(
            self, write_error, write_results, read_results)


class _PartReportBase:
    """Shared roll-ups (the reference's report_common! macro,
    src/file/file_part.rs:457-568)."""

    file_part: FilePart
    read_results: dict  # (chunk_idx, loc_idx) -> (ok: Optional[bool], err)

    def total_chunks(self) -> int:
        return len(self.file_part.all_chunks())

    def chunk_integrity(self, ci: int) -> LocationIntegrity:
        chunk = self.file_part.all_chunks()[ci]
        best = LocationIntegrity.UNAVAILABLE
        for li in range(len(chunk.locations)):
            res = self.read_results.get((ci, li))
            integ = self._to_integrity(res)
            if integ < best:
                best = integ
            if best == LocationIntegrity.VALID:
                break
        return best

    @staticmethod
    def _to_integrity(res: Optional[tuple]) -> LocationIntegrity:
        if res is None:
            return LocationIntegrity.VALID  # location never read (resilver)
        ok, _err = res
        if ok is True:
            return LocationIntegrity.VALID
        if ok is False:
            return LocationIntegrity.INVALID
        return LocationIntegrity.UNAVAILABLE

    def healthy_chunks(self) -> list[Chunk]:
        return [c for ci, c in enumerate(self.file_part.all_chunks())
                if self.chunk_integrity(ci) == LocationIntegrity.VALID]

    def unhealthy_chunks(self) -> list[Chunk]:
        return [c for ci, c in enumerate(self.file_part.all_chunks())
                if self.chunk_integrity(ci) != LocationIntegrity.VALID]

    def unavailable_locations(self) -> list[tuple[Location, str]]:
        out = []
        chunks = self.file_part.all_chunks()
        for (ci, li), (ok, err) in self.read_results.items():
            if ok is None:
                out.append((chunks[ci].locations[li], err or ""))
        return out

    def invalid_locations(self) -> list[Location]:
        chunks = self.file_part.all_chunks()
        return [chunks[ci].locations[li]
                for (ci, li), (ok, _e) in self.read_results.items()
                if ok is False]

    def locations_with_integrity(
            self) -> Iterator[tuple[Location, LocationIntegrity]]:
        chunks = self.file_part.all_chunks()
        for (ci, li), res in sorted(self.read_results.items()):
            yield chunks[ci].locations[li], self._to_integrity(res)

    def is_ideal(self) -> bool:
        return self.integrity().is_ideal()

    def is_available(self) -> bool:
        return self.integrity().is_available()


class VerifyPartReport(_PartReportBase):
    """(src/file/file_part.rs:570-647)"""

    def __init__(self, file_part: FilePart, read_results: dict) -> None:
        self.file_part = file_part
        self.read_results = read_results

    def integrity(self) -> FileIntegrity:
        d = len(self.file_part.data)
        total = self.total_chunks()
        healthy = len(self.healthy_chunks())
        if healthy == total:
            return FileIntegrity.VALID
        if healthy >= d:
            return FileIntegrity.DEGRADED
        return FileIntegrity.UNAVAILABLE

    def __str__(self) -> str:
        return (f"{self.integrity()}: {len(self.unhealthy_chunks())}/"
                f"{self.total_chunks()} unhealthy chunks")

    def display_full_report(self) -> str:
        lines = [f"part\t{self.integrity()}"]
        for ci, chunk in enumerate(self.file_part.all_chunks()):
            lines.append(
                f"chunk\t{self.chunk_integrity(ci)}\t{chunk.hash}")
            for li, location in enumerate(chunk.locations):
                ok, err = self.read_results.get((ci, li), (None, None))
                integ = self._to_integrity((ok, err))
                if err:
                    lines.append(f"location\t{integ}\t{location}\t{err}")
                else:
                    lines.append(f"location\t{integ}\t{location}")
        return "\n".join(lines) + "\n"


class ResilverPartReport(_PartReportBase):
    """(src/file/file_part.rs:671-838)"""

    def __init__(self, file_part: FilePart, write_error: Optional[str],
                 write_results: dict, read_results: dict) -> None:
        self.file_part = file_part
        self.write_error = write_error
        self.write_results = write_results
        self.read_results = read_results

    def chunk_integrity(self, ci: int) -> LocationIntegrity:
        integ = super().chunk_integrity(ci)
        if integ == LocationIntegrity.VALID:
            return integ
        locations, _err = self.write_results.get(ci, (None, None))
        if locations:
            return LocationIntegrity.VALID
        return integ

    def successful_writes(self) -> list[list[Location]]:
        return [locs for locs, err in self.write_results.values()
                if locs is not None]

    def failed_writes(self) -> list[str]:
        errors = [err for _l, err in self.write_results.values()
                  if err is not None]
        if self.write_error is not None:
            errors.append(self.write_error)
        return errors

    def new_locations(self) -> list[Location]:
        return [loc for locs in self.successful_writes() for loc in locs]

    def rebuild_error(self) -> Optional[str]:
        return self.write_error

    def integrity(self) -> FileIntegrity:
        d = len(self.file_part.data)
        total = self.total_chunks()
        healthy = sum(
            1 for ci in range(total)
            if self.chunk_integrity(ci) == LocationIntegrity.VALID
        )
        if healthy == total:
            # Preserves the reference's `> 1` (file_part.rs:698-704).
            if len(self.successful_writes()) > 1:
                return FileIntegrity.RESILVERED
            return FileIntegrity.VALID
        if healthy >= d:
            return FileIntegrity.DEGRADED
        return FileIntegrity.UNAVAILABLE

    def __str__(self) -> str:
        return (f"{self.integrity()}: {len(self.successful_writes())}/"
                f"{self.total_chunks()} chunks modified")

    def display_full_report(self) -> str:
        head = f"part\t{self.integrity()}"
        if self.write_error:
            head += f"\t{self.write_error}"
        lines = [head]
        for ci, chunk in enumerate(self.file_part.all_chunks()):
            lines.append(
                f"chunk\t{self.chunk_integrity(ci)}\t{chunk.hash}")
            for li, location in enumerate(chunk.locations):
                res = self.read_results.get((ci, li))
                integ = self._to_integrity(res)
                err = res[1] if res else None
                if err:
                    lines.append(f"location\t{integ}\t{location}\t{err}")
                else:
                    lines.append(f"location\t{integ}\t{location}")
            _locs, werr = self.write_results.get(ci, (None, None))
            if werr:
                lines.append(f"error\t{werr}")
        return "\n".join(lines) + "\n"
