"""Content-addressed read cache for the serve path (the port of
``chunky_bits_tpu/file/chunk_cache.py``).

The reference has no read-side caching at all — every GET re-fetches,
re-verifies and (when degraded) re-decodes each chunk
(src/file/file_part.rs:73-135).  This module is a bounded,
byte-budgeted LRU keyed by the chunk's SHA-256 digest.
Because chunks are content-addressed, a digest fully identifies the
bytes, so a hit legitimately skips the network/disk fetch *and* the
hash verification — the two costs that dominate a warm read on a small
host (memory-access behavior, not GF arithmetic, dominates erasure
coding once kernels are tuned; arXiv:2108.02692).

Invariants:

- **Verified buffers only.**  The fetch path inserts only after
  ``AnyHash.verify`` passed; any other producer (e.g. RS-reconstructed
  rows) must go through :meth:`insert_verified`, which re-hashes and
  rejects a mismatch — a corrupted buffer can never enter the cache.
- **Whole chunks only.**  Range/seek trimming happens downstream
  (``FileReadBuilder`` slices, the gateway serves the slice), so a
  ranged GET both fills and is served by the same whole-chunk entries.
- **Single event loop.**  Instances are per-event-loop (the cluster
  hands them out the way it does encode batchers); all bookkeeping runs
  on the loop thread, so there are no locks.

Singleflight: N concurrent readers of one digest trigger ONE fetch; the
losers await the winner's verified buffer.  A winner that dies (error or
cancellation) does not doom the waiters — they retry, and one of them
becomes the new winner.
"""

from __future__ import annotations

import asyncio
from collections import OrderedDict
from dataclasses import dataclass
from typing import Awaitable, Callable, Optional

from chunky_bits_tpu_torch.file.hashing import AnyHash


@dataclass
class CacheStats:
    """Counter snapshot surfaced through ``file/profiler.py``."""

    hits: int
    misses: int
    coalesced: int
    inserts: int
    evictions: int
    rejects: int
    size_bytes: int
    capacity_bytes: int
    entries: int

    def to_obj(self) -> dict:
        """Plain-dict form (the metrics registry's cache collector and
        the ``chunky-bits stats`` renderer read this)."""
        return {
            "hits": self.hits, "misses": self.misses,
            "coalesced": self.coalesced, "inserts": self.inserts,
            "evictions": self.evictions, "rejects": self.rejects,
            "size_bytes": self.size_bytes,
            "capacity_bytes": self.capacity_bytes,
            "entries": self.entries,
        }

    def __str__(self) -> str:
        return (f"Cache<hits={self.hits} misses={self.misses} "
                f"coalesced={self.coalesced} evictions={self.evictions} "
                f"rejects={self.rejects} "
                f"bytes={self.size_bytes}/{self.capacity_bytes}>")


class _Flight:
    """One in-flight fetch.  An Event (not a Future) carries the outcome:
    a Future with an un-awaited exception would warn at GC, and waiter
    cancellation must never cancel the winner's fetch."""

    __slots__ = ("event", "result", "died")

    def __init__(self) -> None:
        self.event = asyncio.Event()
        self.result: Optional[bytes] = None  # None = all locations failed
        self.died = False  # winner raised/cancelled: waiters retry


class ChunkCache:
    """Bounded byte-budget LRU of verified chunk buffers, digest-keyed,
    with singleflight fetch deduplication."""

    #: all bookkeeping runs lock-free on the owning loop's thread (the
    #: "single event loop" invariant above): host-pipeline workers never
    #: call into it
    LOOP_BOUND = True

    def __init__(self, capacity_bytes: int) -> None:
        if capacity_bytes <= 0:
            raise ValueError("capacity_bytes must be positive")
        self.capacity = int(capacity_bytes)
        self._entries: "OrderedDict[bytes, bytes]" = OrderedDict()
        self._size = 0
        self._inflight: dict[bytes, _Flight] = {}
        self.hits = 0
        self.misses = 0  # fetches actually started (probes don't count)
        self.coalesced = 0  # waiters served by another reader's fetch
        self.inserts = 0
        self.evictions = 0
        self.rejects = 0  # corrupted pre-insert buffers refused
        # weakly self-register with the process metrics registry so a
        # /metrics scrape sees every live cache's counters (reads of
        # plain ints from the scrape thread are benign; all MUTATION
        # stays on the owning loop — the LOOP_BOUND contract holds)
        from chunky_bits_tpu_torch.obs.metrics import get_registry

        get_registry().register_source("cache", self)

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def size_bytes(self) -> int:
        return self._size

    def contains(self, digest: bytes) -> bool:
        """Presence probe that neither counts a hit nor freshens LRU —
        for observers (the gateway access log's hit/miss tag, the
        sendfile-eligibility check) that must not skew the hit rate or
        the eviction order the serving reads establish."""
        return digest in self._entries

    def get(self, digest: bytes) -> Optional[bytes]:
        """The verified bytes for ``digest``, freshened to MRU, or None.
        A miss is not counted here — only a fetch that actually starts
        (or joins) counts, so slot-prefill probes don't skew the rate."""
        buf = self._entries.get(digest)
        if buf is None:
            return None
        self._entries.move_to_end(digest)
        self.hits += 1
        return buf

    async def get_or_fetch(
        self, digest: bytes,
        fetch: Callable[[], Awaitable[Optional[object]]],
    ) -> Optional[object]:
        """Singleflight lookup: a hit returns the cached bytes; on a miss
        exactly one caller runs ``fetch`` (which must return a VERIFIED
        buffer, or None when the chunk is unreachable) while concurrent
        callers await its outcome.  The winner's original buffer is
        returned to it (zero-copy for its own stream); waiters get the
        normalized cached bytes."""
        while True:
            buf = self.get(digest)
            if buf is not None:
                return buf
            flight = self._inflight.get(digest)
            if flight is None:
                break
            self.coalesced += 1
            # the winner sets the event in a finally even on error or
            # cancel (and `died` hands the flight to a waiter), so this
            # waits exactly as long as the winner's fetch
            # lint: unbounded-await-ok the winner sets the event in a
            # finally even on error/cancel (and `died` hands the flight
            # to a waiter), so this waits exactly as long as the
            # winner's fetch — which is itself bounded by the location
            # layer's network timeouts
            await flight.event.wait()
            if flight.died:
                continue  # winner never produced an outcome: take over
            return flight.result
        self.misses += 1
        flight = _Flight()
        self._inflight[digest] = flight
        try:
            data = await fetch()
        except BaseException:
            flight.died = True
            raise
        finally:
            self._inflight.pop(digest, None)
            flight.event.set()
        if data is not None:
            stored = self._insert(digest, data)
            # waiters get the cached bytes when stored (the one copy that
            # outlives this read); an over-budget buffer is shared as-is
            flight.result = stored if stored is not None else data
        return data

    async def insert_verified(self, hash_: AnyHash,
                              data: bytes | bytearray | memoryview
                              ) -> bool:
        """Verify-then-insert for buffers that did NOT come off a
        verified fetch (RS-reconstructed rows, pre-warming).  Re-hashes
        off-loop; a digest mismatch is rejected and counted — corrupted
        bytes never enter the cache."""
        if hash_.algorithm != "sha256" or len(data) > self.capacity:
            return False
        if not await hash_.verify_async(data):
            self.rejects += 1
            return False
        return self._insert(hash_.value.digest, data) is not None

    def _insert(self, digest: bytes, data: bytes | bytearray | memoryview
                ) -> Optional[bytes]:
        """Store ``data`` (normalized to bytes — an mmap view must not
        pin its inode for the cache's lifetime), evicting LRU entries
        past the byte budget.  Returns the stored bytes, or None when
        ``data`` alone exceeds the whole budget."""
        n = len(data)
        if n > self.capacity:
            return None
        buf = data if isinstance(data, bytes) else bytes(data)
        old = self._entries.pop(digest, None)
        if old is not None:
            self._size -= len(old)
        self._entries[digest] = buf
        self._size += n
        self.inserts += 1
        while self._size > self.capacity:
            _, evicted = self._entries.popitem(last=False)
            self._size -= len(evicted)
            self.evictions += 1
        return buf

    def stats(self) -> CacheStats:
        return CacheStats(
            hits=self.hits, misses=self.misses, coalesced=self.coalesced,
            inserts=self.inserts, evictions=self.evictions,
            rejects=self.rejects, size_bytes=self._size,
            capacity_bytes=self.capacity, entries=len(self._entries),
        )
