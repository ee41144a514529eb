"""Streaming ingest pipeline (the port of ``chunky_bits_tpu/file/writer.py``).

Mirrors the reference's ``FileWriteBuilder`` (src/file/writer.rs): read
``d * chunk_size`` bytes per part, encode + write each part concurrently
(bounded by a semaphore, default concurrency 10), collect parts in order,
fail fast on the first error.  Defaults match writer.rs:50-59 (chunk_size
1 MiB, d=3, p=2, concurrency 10).

A device wants batches: ``batch_parts > 1`` stages parts and encodes them
in batched dispatches (grouped by shard length, so full-size stripes share
one [B, d, S] dispatch) without changing the ordered assembly or the
fail-fast path.  Parts go to encode in sub-blocks of ``stage_parts`` as
they fill, so the read loop, the encode and the destination writes
overlap; an EncodeHashBatcher (the caller's shared one, or one the writer
makes for merge-preferring backends) merges concurrent sub-blocks back
into dispatches of up to ``batch_parts`` parts.

The read loop lands part bytes directly in rows of the [stage_size, d,
chunk] staging block (``aio.read_exact_into``), and a reader with
``view_parts`` (a local file) hands whole staging blocks over as
read-only page-cache views, so full-length parts reach the encoder with
no copy; only the short tail part is repacked.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, replace
from typing import Optional

import numpy as np

from chunky_bits_tpu_torch.errors import FileWriteError
from chunky_bits_tpu_torch.file.file_part import FilePart
from chunky_bits_tpu_torch.file.file_reference import FileReference
from chunky_bits_tpu_torch.ops import get_coder
from chunky_bits_tpu_torch.utils import aio


@dataclass
class FileWriteBuilder:
    destination: object = None
    chunk_size: int = 1 << 20
    data: int = 3
    parity: int = 2
    concurrency: int = 10
    batch_parts: int = 1
    #: staging granularity: parts are flushed to encode in sub-blocks of
    #: this size, so staging never serializes more than this many parts
    #: behind one copy (batch_parts stays the dispatch coalescing bound)
    stage_parts: int = 8
    backend: Optional[str] = None
    content_type: Optional[str] = None
    #: an ops.batching.EncodeHashBatcher shared across concurrent writes
    #: (coalesces many small files into one device dispatch), or a zero-arg
    #: callable resolving to one inside the running loop, or None.
    encode_batcher: object = None
    #: a parallel.host_pipeline.HostPipeline running this write's host
    #: compute, or None for the process-shared one
    host_pipeline: object = None
    #: block-digest tree granularity (the ``repair_block_bytes``
    #: tunable): chunks longer than this get a per-block sha256 tree in
    #: their metadata for damage localization; 0 = off
    repair_block_bytes: int = 0
    #: erasure code for every part this writer emits: "rs" (Reed-Solomon,
    #: the default) or "pm-msr" (product-matrix MSR, ops/pm_msr.py; needs
    #: parity >= data-1 and an alpha-divisible chunk size).  Cluster
    #: profiles route their ``code`` knob here.
    code: str = "rs"

    # builder setters (writer.rs:78-110); return copies like the Rust
    # builder's consume-and-return

    def with_destination(self, destination) -> "FileWriteBuilder":
        return replace(self, destination=destination)

    def with_chunk_size(self, chunk_size: int) -> "FileWriteBuilder":
        return replace(self, chunk_size=chunk_size)

    def with_data_chunks(self, data: int) -> "FileWriteBuilder":
        return replace(self, data=data)

    def with_parity_chunks(self, parity: int) -> "FileWriteBuilder":
        return replace(self, parity=parity)

    def with_concurrency(self, concurrency: int) -> "FileWriteBuilder":
        return replace(self, concurrency=concurrency)

    def with_batch_parts(self, batch_parts: int) -> "FileWriteBuilder":
        return replace(self, batch_parts=batch_parts)

    def with_stage_parts(self, stage_parts: int) -> "FileWriteBuilder":
        return replace(self, stage_parts=stage_parts)

    def with_backend(self, backend: Optional[str]) -> "FileWriteBuilder":
        return replace(self, backend=backend)

    def with_content_type(self, content_type: Optional[str]
                          ) -> "FileWriteBuilder":
        return replace(self, content_type=content_type)

    def with_encode_batcher(self, encode_batcher) -> "FileWriteBuilder":
        return replace(self, encode_batcher=encode_batcher)

    def with_host_pipeline(self, host_pipeline) -> "FileWriteBuilder":
        return replace(self, host_pipeline=host_pipeline)

    def with_repair_block_bytes(self, repair_block_bytes: int
                                ) -> "FileWriteBuilder":
        return replace(self, repair_block_bytes=repair_block_bytes)

    def with_code(self, code: str) -> "FileWriteBuilder":
        return replace(self, code=code)

    async def write(self, reader: aio.AsyncByteReader) -> FileReference:
        if self.concurrency <= 1:
            raise FileWriteError("concurrency must be > 1")
        batch_parts = max(1, min(self.batch_parts, self.concurrency))
        stage_size = max(1, min(batch_parts, self.stage_parts))
        d, p = self.data, self.parity
        # raises ErasureError on an unknown code or a geometry the code
        # cannot run (e.g. pm-msr with parity < data-1) — a writer must
        # fail loudly at the first part, not emit an unreadable ref
        coder = get_coder(d, p, self.backend, self.code)
        if coder.shard_len(d * self.chunk_size) != self.chunk_size:
            raise FileWriteError(
                f"chunk_size {self.chunk_size} incompatible with "
                f"code {coder.code!r}: full-length shards must not "
                f"need sub-symbol padding (pm-msr: chunk_size % "
                f"alpha == 0, alpha = data-1)")
        from chunky_bits_tpu_torch.file.collection_destination import \
            as_destination
        from chunky_bits_tpu_torch.parallel.host_pipeline import \
            get_host_pipeline

        # the multi-core host plane: the read loop overlaps the encode
        # and hashing on the pipeline's workers
        pipeline = self.host_pipeline or get_host_pipeline()

        destination = as_destination(self.destination)

        sem = asyncio.Semaphore(self.concurrency)

        encode_batcher = self.encode_batcher
        if callable(encode_batcher):
            encode_batcher = encode_batcher()
        merging = getattr(coder.backend, "prefers_merged_batches", False)
        own_batcher = False
        if encode_batcher is None and merging and batch_parts > stage_size:
            # device backend with no shared batcher: coalesce this
            # write's own sub-blocks back into [<=batch_parts, d, S]
            # dispatches, so streamed staging doesn't shrink the device
            # batches that amortize per-dispatch overhead.  max_batch
            # counts batcher REQUESTS — sub-blocks of up to stage_size
            # parts each — so divide to keep the merged dispatch within
            # batch_parts parts.
            from chunky_bits_tpu_torch.ops.batching import EncodeHashBatcher

            encode_batcher = EncodeHashBatcher(
                backend=self.backend,
                max_batch=max(1, batch_parts // stage_size),
                host_pipeline=pipeline)
            own_batcher = True

        # Read-ahead bound: by default at most two sub-blocks of raw parts
        # may sit staged-or-encoding at once (one encoding, one filling);
        # without it a large concurrency lets the read loop race GiBs of
        # buffers ahead of the encoder.  Merge-preferring device backends
        # get a window of batch_parts instead: pending sub-blocks are what
        # the batcher merges into full-size dispatches.
        encode_ahead = asyncio.Semaphore(
            max(2 * stage_size, batch_parts if merging else 0))
        chunk = self.chunk_size
        part_bytes = d * chunk
        # The current staging block: the read loop lands part bytes
        # DIRECTLY into rows of this [stage_size, d, chunk] array (via
        # readinto when the reader supports it), so a full-length part
        # reaches the encoder with zero restaging copies — the bytes are
        # already in batched [B, d, S] device layout.
        block: Optional[np.ndarray] = None
        lens: list[int] = []
        total_bytes = 0

        def stage(blk: np.ndarray, ls: list[int]):
            """Group a staging block's parts by shard length.  The
            common group — full-length parts, which the read loop already
            laid out back-to-back — is handed to encode as a zero-copy
            slice view of the block; only a short tail part (at most one
            per write: a short read ends the stream) is repacked to its
            smaller shard length with zero padding.  Runs in a worker
            thread for the repack memcpy."""
            groups: dict[int, list[int]] = {}
            for i, length in enumerate(ls):
                shard_len = coder.shard_len(length)
                groups.setdefault(shard_len, []).append(i)
            staged_groups = []
            for shard_len, indices in groups.items():
                if shard_len == 0:
                    staged_groups.append((0, indices, None))
                    continue
                if shard_len == chunk:
                    # split full-length parts out first: a near-full tail
                    # (within d-1 bytes of part_bytes) shares this
                    # shard_len but needs zero padding, and must not drag
                    # the full parts through the repack
                    full = [i for i in indices if ls[i] == part_bytes]
                    if full and full[-1] + 1 - full[0] == len(full):
                        staged_groups.append(
                            (chunk, full, blk[full[0]:full[-1] + 1]))
                        indices = [i for i in indices
                                   if ls[i] != part_bytes]
                        if not indices:
                            continue
                stacked = np.empty((len(indices), d, shard_len),
                                   dtype=np.uint8)
                for bi, i in enumerate(indices):
                    length = ls[i]
                    flat = stacked[bi].reshape(d * shard_len)
                    flat[:length] = blk[i].reshape(-1)[:length]
                    if length < d * shard_len:
                        flat[length:] = 0
                staged_groups.append((shard_len, indices, stacked))
            return staged_groups

        async def encode_staged(blk: np.ndarray, ls: list[int]):
            """Encode + hash a batch of parts; same-shard-length stripes
            share one dispatch (and one fused native encode+hash pass).
            With a shared encode batcher, the dispatch additionally
            coalesces with other concurrent writes (many-small-files /
            gateway ingest)."""
            groups = await pipeline.run(
                "stage", lambda: stage(blk, ls), nbytes=sum(ls))
            results: dict[int, tuple[list, list, int, Optional[list]]] = {}

            async def encode_group(shard_len, indices, stacked):
                if shard_len == 0:
                    for i in indices:
                        results[i] = ([], [], 0, None)
                    return
                if encode_batcher is not None:
                    parity_batch, digest_batch = \
                        await encode_batcher.encode_hash(
                            d, p, stacked, code=coder.code)
                else:
                    parity_batch, digest_batch = \
                        await pipeline.encode_hash(coder, stacked)
                for bi, i in enumerate(indices):
                    results[i] = (
                        list(stacked[bi]),
                        list(parity_batch[bi]),
                        shard_len,
                        [row.tobytes() for row in digest_batch[bi]],
                    )

            await aio.gather_or_cancel(
                [encode_group(*g) for g in groups])
            return [results[i] for i in range(len(ls))]

        async def write_part(precomputed) -> FilePart:
            try:
                return await FilePart.write_with_coder(
                    coder, destination, b"", 0, precomputed=precomputed,
                    pipeline=pipeline,
                    block_bytes=self.repair_block_bytes,
                )
            finally:
                sem.release()

        batch_tasks: list[asyncio.Task] = []

        async def run_batch(blk, ls) -> list[FilePart]:
            try:
                pre = await encode_staged(blk, ls)
            except BaseException:
                for _ in ls:
                    sem.release()
                    encode_ahead.release()
                raise
            # staging block consumed; let the read loop fill the next
            # sub-block while these parts flow to the destination
            for _ in ls:
                encode_ahead.release()
            return await aio.gather_or_cancel(
                [write_part(x) for x in pre])

        def flush() -> None:
            """Hand the current staging block to a background
            encode+write task — the read loop keeps streaming into a
            fresh block while the previous one is on the device / in
            flight to storage (double buffering; the semaphore still
            bounds total parts in flight)."""
            nonlocal block, lens
            blk, ls, block, lens = block, lens, None, []
            if ls:
                batch_tasks.append(asyncio.create_task(run_batch(blk, ls)))

        checked = 0

        def check_failed() -> None:
            """Fail fast: surface the first completed batch's error
            without waiting for the read loop to finish (the reference's
            oneshot error short-circuit, writer.rs:235-247).  A cursor
            skips still-pending tasks already probed so the scan stays
            O(batches) over the whole stream."""
            nonlocal checked
            while checked < len(batch_tasks):
                t = batch_tasks[checked]
                if not t.done():
                    break
                if not t.cancelled():
                    exc = t.exception()
                    if exc is not None:
                        raise exc
                checked += 1

        async def cancel_all() -> None:
            for t in batch_tasks:
                t.cancel()
            await asyncio.gather(*batch_tasks, return_exceptions=True)

        # Zero-copy source path: a reader exposing ``view_parts`` (local
        # regular files, utils/aio.py) serves whole staging blocks as
        # read-only page-cache views — full-length parts reach the
        # encoder and the shard writers with no source memcpy at all.
        # The tail (< one part) falls through to the readinto path.
        view_parts = getattr(reader, "view_parts", None)

        try:
            while True:
                # these are flow-control permits, not mutual exclusion:
                # each staged part carries its permits until its write
                # task completes (released in _write_part / on failure
                # by cancel_all), so acquire/release pair across tasks
                # lint: lock-discipline-ok permit transferred to the write task
                await sem.acquire()
                # lint: lock-discipline-ok permit transferred to the write task
                await encode_ahead.acquire()
                if view_parts is not None and block is None:
                    mv = await view_parts(part_bytes, stage_size)
                    if mv is None:
                        view_parts = None  # tail/unmappable: byte path
                    else:
                        blk = np.frombuffer(mv, dtype=np.uint8
                                            ).reshape(-1, d, chunk)
                        # permits for the parts beyond the first
                        for _ in range(blk.shape[0] - 1):
                            # lint: lock-discipline-ok permit transferred to the write task
                            await sem.acquire()
                            # lint: lock-discipline-ok permit transferred to the write task
                            await encode_ahead.acquire()
                        total_bytes += blk.shape[0] * part_bytes
                        block, lens = blk, [part_bytes] * blk.shape[0]
                        flush()
                        check_failed()
                        continue
                if block is None:
                    block = np.empty((stage_size, d, chunk),
                                     dtype=np.uint8)
                got = await aio.read_exact_into(
                    reader, memoryview(block[len(lens)].reshape(-1)))
                if got == 0:
                    sem.release()
                    encode_ahead.release()
                    break
                total_bytes += got
                lens.append(got)
                short_read = got < part_bytes
                if len(lens) >= stage_size or short_read:
                    # the just-staged parts keep their permits until their
                    # write tasks complete
                    flush()
                    check_failed()
                if short_read:
                    break
            flush()
            nested = await asyncio.gather(*batch_tasks)
            parts = [part for batch in nested for part in batch]
        except BaseException:
            # Shards already written stay put: they are content-addressed
            # and may be shared with other files' identical parts, so
            # blind deletion could destroy durable data.  Orphans are
            # reclaimed by the reference-checking find-unused-hashes GC
            # (reference behavior, main.rs:329-435).
            await cancel_all()
            raise
        finally:
            if own_batcher:
                # writer-owned batcher: drain its in-flight dispatches so
                # no task outlives the write (shared batchers belong to
                # the caller's scope)
                await encode_batcher.aclose()
        return FileReference(
            content_type=self.content_type,
            compression=None,
            length=total_bytes,
            parts=list(parts),
        )
