"""Streaming read pipeline with seek/take and part-level prefetch (the
port of ``chunky_bits_tpu/file/reader.py``).

Mirrors the reference's ``FileReadBuilder`` (src/file/reader.rs):
byte-range reads (seek skips whole parts then trims the first yielded
buffer, reader.rs:39-61), default prefetch of 5 parts in flight
(reader.rs:96), ``buffer_bytes`` to derive prefetch depth from a byte
budget (reader.rs:123-131), and trailing trim to the requested length.
"""

from __future__ import annotations

import asyncio
from collections import deque
from dataclasses import dataclass, field, replace
from typing import AsyncIterator, Optional

from chunky_bits_tpu_torch.file.file_part import FilePart
from chunky_bits_tpu_torch.file.file_reference import FileReference
from chunky_bits_tpu_torch.file.location import (LocationContext,
                                                 default_context)
from chunky_bits_tpu_torch.utils import aio

DEFAULT_BUFFER = 5


@dataclass
class FileReadBuilder:
    file: FileReference
    buffer: int = DEFAULT_BUFFER
    cx: LocationContext = field(default_factory=default_context)
    seek: int = 0
    take: int = 0
    backend: Optional[str] = None  # erasure backend for reconstruction
    #: shared ReconstructBatcher (e.g. the cluster's per-loop instance,
    #: so concurrent GETs coalesce into one device dispatch); when None
    #: the stream creates — and owns closing — its own
    batcher: Optional[object] = None
    #: content-addressed read cache (file.chunk_cache.ChunkCache); hits
    #: skip fetch and verify, and whole verified chunks are what is
    #: cached even under seek/take (trimming happens here, at the edge)
    cache: Optional[object] = None
    #: host compute executor for read-side hash verification
    #: (parallel/host_pipeline.HostPipeline); None = the process-shared
    #: pipeline
    pipeline: Optional[object] = None

    def with_backend(self, backend: Optional[str]) -> "FileReadBuilder":
        return replace(self, backend=backend)

    def with_batcher(self, batcher) -> "FileReadBuilder":
        return replace(self, batcher=batcher)

    def with_cache(self, cache) -> "FileReadBuilder":
        return replace(self, cache=cache)

    def with_pipeline(self, pipeline) -> "FileReadBuilder":
        return replace(self, pipeline=pipeline)

    def with_seek(self, seek: int) -> "FileReadBuilder":
        return replace(self, seek=seek)

    def with_take(self, take: int) -> "FileReadBuilder":
        return replace(self, take=take)

    def with_buffer(self, buffer: int) -> "FileReadBuilder":
        return replace(self, buffer=buffer)

    def location_context(self, cx: LocationContext) -> "FileReadBuilder":
        return replace(self, cx=cx)

    def buffer_bytes(self, nbytes: int) -> "FileReadBuilder":
        if self.file.parts:
            part_len = self.file.parts[0].len_bytes()
            if part_len > 0:
                buffer = (nbytes + part_len // 2) // part_len
                return replace(self, buffer=max(buffer, 1))
        return self

    def len_bytes(self) -> int:
        """Bytes this read will yield (reader.rs:133-142)."""
        length = self.file.len_bytes()
        if self.take == 0:
            return max(length - self.seek, 0)
        if length > self.seek + self.take:
            return self.take
        if length > self.seek:
            return length - self.seek
        return 0

    def file_reference(self) -> FileReference:
        return self.file

    async def stream(self) -> AsyncIterator[bytes]:
        """Yield per-chunk buffers (bytes or zero-copy page-cache views)
        with ``buffer`` parts prefetched — chunk bytes flow from storage
        to the consumer without a per-part join copy.

        The prefetched parts share one ReconstructBatcher, so a degraded
        read of many parts rebuilds its missing shards in batched device
        dispatches instead of one per part.  A builder-provided batcher
        (the cluster's per-loop shared instance) additionally coalesces
        across concurrent streams and is NOT closed here — it outlives
        any one read the way the cluster's encode batcher does."""
        from chunky_bits_tpu_torch.ops.batching import ReconstructBatcher

        batcher = self.batcher
        owns_batcher = batcher is None
        if owns_batcher:
            batcher = ReconstructBatcher(backend=self.backend)
        remaining = self.len_bytes()
        jobs: list[tuple[FilePart, int]] = []
        seek = self.seek
        budget = remaining
        for part in self.file.parts:
            if budget <= 0:
                # parts wholly past the take window are never read: a
                # take-limited stream must not touch (or depend on the
                # health of) trailing parts the caller never asked for
                break
            part_len = part.len_bytes()
            if seek >= part_len and seek != 0:
                seek -= part_len
                continue
            jobs.append((part, seek))
            budget -= part_len - seek
            seek = 0
        tasks: deque[asyncio.Task] = deque()
        idx = 0
        try:
            while idx < len(jobs) or tasks:
                while idx < len(jobs) and len(tasks) < max(self.buffer, 1):
                    part, skip = jobs[idx]
                    tasks.append(
                        asyncio.ensure_future(
                            self._read_part(part, skip, batcher)))
                    idx += 1
                for data in await tasks.popleft():
                    if len(data) > remaining:
                        data = data[:remaining]
                    remaining -= len(data)
                    if data:
                        yield data
                    if remaining <= 0:
                        break
                if remaining <= 0:
                    break
        finally:
            for t in tasks:
                t.cancel()
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
            if owns_batcher:
                await batcher.aclose()

    async def _read_part(self, part: FilePart, skip: int,
                         batcher=None) -> list:
        # backend resolution happens lazily inside part.read_buffers,
        # only when reconstruction is actually needed
        buffers = await part.read_buffers(self.cx, backend=self.backend,
                                          batcher=batcher,
                                          cache=self.cache,
                                          pipeline=self.pipeline)
        if not skip:
            return buffers
        out = []
        for buf in buffers:
            if skip >= len(buf):
                skip -= len(buf)
                continue
            out.append(buf[skip:] if skip else buf)
            skip = 0
        return out

    def reader(self) -> aio.AsyncByteReader:
        return aio.IterReader(self.stream())

    async def read_all(self) -> bytes:
        out = []
        async for chunk in self.stream():
            out.append(chunk)
        return b"".join(out)
