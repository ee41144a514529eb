"""Whole-file metadata: the durable state of the system (the port of
``chunky_bits_tpu/file/file_reference.py``).

Wire-compatible with the reference's ``FileReference``:

    content_type: <optional str>
    compression:  <optional, reserved>
    length: <u64>
    parts:
      - chunksize: <usize>
        data:   [{sha256: <hex>, locations: [...]}, ...]
        parity: [{sha256: <hex>, locations: [...]}, ...]

References written by either package read back through the other.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Optional

from chunky_bits_tpu_torch.errors import SerdeError
from chunky_bits_tpu_torch.file.file_part import (
    FileIntegrity,
    FilePart,
    ResilverPartReport,
    VerifyPartReport,
)
from chunky_bits_tpu_torch.file.location import Location, LocationContext
from chunky_bits_tpu_torch.utils import aio

RESILVER_CONCURRENCY = 10  # parts in flight (file_reference.rs:110)


@dataclass
class FileReference:
    length: Optional[int]
    parts: list[FilePart]
    content_type: Optional[str] = None
    compression: Optional[str] = None

    def len_bytes(self) -> int:
        if self.length is not None:
            return self.length
        return sum(part.len_bytes() for part in self.parts)

    # ---- serde ----

    def to_obj(self) -> dict:
        obj: dict = {}
        if self.compression is not None:
            obj["compression"] = self.compression
        if self.content_type is not None:
            obj["content_type"] = self.content_type
        obj["length"] = self.length
        obj["parts"] = [p.to_obj() for p in self.parts]
        return obj

    @classmethod
    def from_obj(cls, obj: dict) -> "FileReference":
        if not isinstance(obj, dict) or "parts" not in obj:
            raise SerdeError("file reference must be a mapping with 'parts'")
        length = obj.get("length")
        return cls(
            length=int(length) if length is not None else None,
            parts=[FilePart.from_obj(p) for p in obj["parts"]],
            content_type=obj.get("content_type"),
            compression=obj.get("compression"),
        )

    # ---- builders ----

    def read_builder(self, cx: Optional[LocationContext] = None):
        from chunky_bits_tpu_torch.file.reader import FileReadBuilder

        builder = FileReadBuilder(self)
        if cx is not None:
            builder = builder.location_context(cx)
        return builder

    @staticmethod
    def write_builder():
        from chunky_bits_tpu_torch.file.writer import FileWriteBuilder

        return FileWriteBuilder()

    # ---- verify / resilver fan-out (file_reference.rs:78-113) ----

    async def verify(self, cx: Optional[LocationContext] = None,
                     pipeline=None) -> "VerifyFileReport":
        # Bounded parts-in-flight, like resilver.  The reference gathers
        # every part at once (file_reference.rs:78-87) — unbounded sockets
        # on a 10 GiB file; bounding is a deliberate improvement.
        from chunky_bits_tpu_torch.parallel.host_pipeline import \
            get_host_pipeline

        sem = asyncio.Semaphore(RESILVER_CONCURRENCY)
        # ONE host pipeline across the whole file: the ~10x10 in-flight
        # location reads funnel their SHA-256 re-hash through its
        # min(N, nproc) workers instead of one thread (multi-core
        # verify), and the report's profiler sees one set of counters
        pipe = pipeline if pipeline is not None else get_host_pipeline()

        async def one(part: FilePart) -> "VerifyPartReport":
            async with sem:
                return await part.verify(cx, pipeline=pipe)

        reports = await aio.gather_or_cancel(
            [one(p) for p in self.parts])
        return VerifyFileReport(list(reports))

    async def resilver(self, destination,
                       cx: Optional[LocationContext] = None,
                       backend: Optional[str] = None,
                       pipeline=None, batcher=None) -> "ResilverFileReport":
        """Rebuild and rewrite every unreadable chunk, ``RESILVER_CONCURRENCY``
        parts in flight.  ``batcher`` is a shared ReconstructBatcher, left
        open here; None makes one for this call and closes it."""
        from chunky_bits_tpu_torch.ops.batching import ReconstructBatcher
        from chunky_bits_tpu_torch.parallel.host_pipeline import \
            get_host_pipeline

        sem = asyncio.Semaphore(RESILVER_CONCURRENCY)
        # All in-flight parts share one batcher: parts degraded by the same
        # node loss share an erasure pattern and rebuild in one dispatch.
        owns_batcher = batcher is None
        if owns_batcher:
            batcher = ReconstructBatcher(backend=backend)
        # ...and one host pipeline for the shard re-hash of the re-read
        pipe = pipeline if pipeline is not None else get_host_pipeline()

        async def one(part: FilePart) -> ResilverPartReport:
            async with sem:
                return await part.resilver(destination, cx, backend=backend,
                                           batcher=batcher, pipeline=pipe)

        try:
            # on failure siblings are cancelled before the drain below, so
            # no part can submit fresh batcher work after aclose
            reports = await aio.gather_or_cancel(
                [one(p) for p in self.parts])
        finally:
            if owns_batcher:
                await batcher.aclose()
        return ResilverFileReport(list(reports))


class _FileReportBase:
    """Roll-ups across parts (file_reference.rs:149-239)."""

    part_reports: list

    def integrity(self) -> FileIntegrity:
        current = FileIntegrity.VALID
        for report in self.part_reports:
            part_integrity = report.integrity()
            if part_integrity > current:
                current = part_integrity
        return current

    def is_ideal(self) -> bool:
        return self.integrity().is_ideal()

    def is_available(self) -> bool:
        return self.integrity().is_available()

    def total_parts(self) -> int:
        return len(self.part_reports)

    def total_chunks(self) -> int:
        return sum(r.total_chunks() for r in self.part_reports)

    def healthy_parts(self) -> list[FilePart]:
        return [r.file_part for r in self.part_reports
                if not r.unhealthy_chunks()]

    def healthy_chunks(self):
        return [c for r in self.part_reports for c in r.healthy_chunks()]

    def unhealthy_chunks(self):
        return [c for r in self.part_reports for c in r.unhealthy_chunks()]

    def unavailable_locations(self):
        return [t for r in self.part_reports
                for t in r.unavailable_locations()]

    def invalid_locations(self) -> list[Location]:
        return [loc for r in self.part_reports
                for loc in r.invalid_locations()]

    def locations_with_integrity(self):
        for r in self.part_reports:
            yield from r.locations_with_integrity()

    def display_full_report(self) -> str:
        out = [f"file\t{self.integrity()}\n"]
        for r in self.part_reports:
            out.append(r.display_full_report())
        return "\n".join(out)


class VerifyFileReport(_FileReportBase):
    def __init__(self, part_reports: list[VerifyPartReport]):
        self.part_reports = part_reports

    def __str__(self) -> str:
        # The reference prints the *healthy* count under the "unhealthy"
        # label (file_reference.rs:243-252); corrected here.
        unhealthy = self.total_parts() - len(self.healthy_parts())
        return (
            f"{self.integrity()}: {unhealthy}/"
            f"{self.total_parts()} unhealthy parts"
        )


class ResilverFileReport(_FileReportBase):
    def __init__(self, part_reports: list[ResilverPartReport]):
        self.part_reports = part_reports

    def rebuild_errors(self) -> list[Optional[str]]:
        return [r.rebuild_error() for r in self.part_reports]

    def new_locations(self) -> list[Location]:
        return [loc for r in self.part_reports for loc in r.new_locations()]

    def successful_writes(self):
        return [w for r in self.part_reports for w in r.successful_writes()]

    def failed_writes(self) -> list[str]:
        return [e for r in self.part_reports for e in r.failed_writes()]

    def resilvered_parts(self) -> list[FilePart]:
        return [r.file_part for r in self.part_reports]

    def modified_parts(self) -> list[FilePart]:
        return [r.file_part for r in self.part_reports
                if r.successful_writes()]

    def __str__(self) -> str:
        return (
            f"{self.integrity()}: {len(self.modified_parts())}/"
            f"{self.total_parts()} parts modified"
        )
