"""The CLI's universal URI: ``cluster#path``, ``cluster[profile]#path``,
``@#file-ref-location``, a bare location, or ``-`` for stdio (the port of
``chunky_bits_tpu/cli/cluster_location.py``).

Mirrors src/bin/chunky-bits/cluster_location.rs: parser (:650-684), display
(:686-705), readers/writers (:101-180), listing (:182-353), resilver/verify
(:355-402), hash streaming (:404-515), and migrate — referencing a file
in-place via range-sliced locations without copying data (:517-620).
"""

from __future__ import annotations

import asyncio
import os
import sys
from dataclasses import dataclass
from typing import AsyncIterator, Optional
from urllib.parse import urlsplit

from chunky_bits_tpu_torch.cluster import (Cluster, ClusterProfile,
                                           FileOrDirectory)
from chunky_bits_tpu_torch.errors import ChunkyBitsError, SerdeError
from chunky_bits_tpu_torch.file import (
    AnyHash,
    FileReadBuilder,
    FileReference,
    Location,
)
from chunky_bits_tpu_torch.utils import aio
from chunky_bits_tpu_torch.utils.yamlio import yaml_load

_warned_once: set[str] = set()


def _warn_once(key: str, message: str) -> None:
    if key not in _warned_once:
        _warned_once.add(key)
        print(message, file=sys.stderr)


class _StdinReader:
    async def read(self, n: int = -1) -> bytes:
        return await asyncio.to_thread(sys.stdin.buffer.read, n)


@dataclass(frozen=True)
class ClusterLocation:
    kind: str  # "cluster" | "file_ref" | "other" | "stdio"
    cluster: Optional[str] = None
    profile: Optional[str] = None
    path: Optional[str] = None
    location: Optional[Location] = None

    # ---- parse / display (cluster_location.rs:650-705) ----

    @staticmethod
    def parse(s: str) -> "ClusterLocation":
        if s == "-":
            return ClusterLocation("stdio")
        prefix, sep, path = s.partition("#")
        if sep and "#" in path:
            raise SerdeError(f"invalid cluster location format: {s}")
        if not sep:
            return ClusterLocation("other", location=Location.parse(s))
        if prefix == "@":
            return ClusterLocation(
                "file_ref", location=Location.parse(path))
        if prefix.endswith("]") and "[" in prefix:
            idx = prefix.rfind("[")
            cluster, profile = prefix[:idx], prefix[idx + 1:-1]
            return ClusterLocation(
                "cluster", cluster=cluster, profile=profile, path=path)
        if prefix and prefix[-1].isalnum():
            return ClusterLocation("cluster", cluster=prefix, path=path)
        raise SerdeError(f"invalid cluster name/file: {prefix}")

    def __str__(self) -> str:
        if self.kind == "stdio":
            return "-"
        if self.kind == "cluster":
            if self.profile is not None:
                return f"{self.cluster}[{self.profile}]#{self.path}"
            return f"{self.cluster}#{self.path}"
        if self.kind == "file_ref":
            return f"@#{self.location}"
        return str(self.location)

    # ---- cluster/profile resolution (cluster_location.rs:622-647) ----

    async def get_cluster_with_profile(
        self, config
    ) -> tuple[Cluster, ClusterProfile]:
        if self.kind != "cluster":
            raise ChunkyBitsError("not a cluster location")
        cluster = await config.get_cluster(self.cluster)
        profile_name = self.profile
        if profile_name is None:
            profile_name = config.get_profile(self.cluster)
        profile = cluster.get_profile(profile_name)
        if profile is None:
            raise ChunkyBitsError(f"Profile not found: {profile_name}")
        return cluster, profile

    async def _load_file_ref(self, config) -> FileReference:
        if self.kind == "cluster":
            cluster = await config.get_cluster(self.cluster)
            return await cluster.get_file_ref(self.path)
        if self.kind == "file_ref":
            import yaml

            data = await self.location.read()
            try:
                obj = yaml_load(data)
            except yaml.YAMLError as err:
                raise SerdeError(
                    f"invalid file reference at {self.location}: {err}"
                ) from err
            return FileReference.from_obj(obj)
        raise ChunkyBitsError(f"no file reference for {self}")

    # ---- read / write (cluster_location.rs:101-180) ----

    async def get_reader(self, config) -> aio.AsyncByteReader:
        if self.kind in ("cluster", "file_ref"):
            file_ref = await self._load_file_ref(config)
            if self.kind == "cluster":
                # the cluster's serve-path builder: shared reconstruct
                # batcher + (when tuned on) the content-addressed cache
                cluster = await config.get_cluster(self.cluster)
                return cluster.file_read_builder(file_ref).reader()
            return FileReadBuilder(file_ref).reader()
        if self.kind == "other":
            return await self.location.reader()
        return _StdinReader()

    async def write_from_reader(self, config, reader: aio.AsyncByteReader
                                ) -> int:
        if self.kind == "cluster":
            cluster, profile = await self.get_cluster_with_profile(config)
            file_ref = await cluster.get_file_writer(profile).write(reader)
            await cluster.write_file_ref(self.path, file_ref)
            return file_ref.len_bytes()
        if self.kind == "file_ref":
            import json

            destination = await config.get_default_destination()
            d = await config.get_default_data_chunks()
            p = await config.get_default_parity_chunks()
            cs = await config.get_default_chunk_size()
            _warn_once(
                "default-destination",
                f"Warning: Writing using default destination data = {d}, "
                f"parity = {p}, chunk_size = 2^{cs}",
            )
            file_ref = await (
                FileReference.write_builder()
                .with_destination(destination)
                .with_data_chunks(d)
                .with_parity_chunks(p)
                .with_chunk_size(1 << cs)
                .write(reader)
            )
            await self.location.write(
                json.dumps(file_ref.to_obj(), indent=2).encode())
            return file_ref.len_bytes()
        if self.kind == "other":
            return await self.location.write_from_reader(reader)
        # stdio: writes block in a worker thread (a slow pipe consumer
        # must not stall the read pipeline's event loop), but hopping
        # threads per 1 MiB chunk costs ~2-4 ms each on a small host —
        # several seconds per GiB of pure scheduling.  Batch chunks to
        # 8 MiB per hop (one extra memcpy, ~50x cheaper than the hops),
        # with a 0.25 s age bound so a slow producer still streams
        # progressively to the consumer instead of freezing per batch.
        import time as _time

        total = 0
        buf = bytearray()
        buf_born = 0.0

        async def flush_buf():
            nonlocal buf
            if buf:
                out, buf = buf, bytearray()
                await asyncio.to_thread(sys.stdout.buffer.write, out)

        while True:
            data = await reader.read(1 << 20)
            if not data:
                break
            total += len(data)
            if not buf:
                buf_born = _time.monotonic()
            buf += data
            if (len(buf) >= (8 << 20)
                    or _time.monotonic() - buf_born > 0.25):
                await flush_buf()
        await flush_buf()
        await asyncio.to_thread(sys.stdout.buffer.flush)
        return total

    # ---- listing (cluster_location.rs:182-353) ----

    async def list_files(self, config) -> list[FileOrDirectory]:
        if self.kind == "cluster":
            cluster = await config.get_cluster(self.cluster)
            return await cluster.list_files(self.path)
        if self.kind == "stdio":
            return [FileOrDirectory("file", "-")]
        loc = self.location
        if loc.is_local():
            return await FileOrDirectory.list(loc.target)
        # http and slab locations list as a single file (the path part)
        return [FileOrDirectory("file", urlsplit(loc.target).path)]

    async def list_files_recursive(self, config
                                   ) -> AsyncIterator[FileOrDirectory]:
        entries = await self.list_files(config)
        if not entries:
            return
        yield entries[0]
        for entry in entries[1:]:
            if entry.is_directory():
                sub = self.make_sub_location(entry.path)
                async for item in sub.list_files_recursive(config):
                    yield item
            else:
                yield entry

    def make_sub_location(self, new_path: str) -> "ClusterLocation":
        """Rebase this location onto a (possibly absolute) listed path
        (cluster_location.rs:253-335)."""
        if self.kind == "cluster":
            return ClusterLocation("cluster", cluster=self.cluster,
                                   profile=self.profile, path=new_path)
        if self.kind == "stdio":
            return self
        loc = self.location
        sub_parts = [p for p in new_path.split("/")
                     if p not in ("", ".", "..")]
        if loc.is_local():
            parent_parts = [p for p in loc.target.split("/")
                            if p not in ("", ".", "..")]
        else:
            parent_parts = [p for p in urlsplit(loc.target).path.split("/")
                            if p]
        i = 0
        for parent_part in parent_parts:
            if i < len(sub_parts) and parent_part == sub_parts[i]:
                i += 1
            else:
                break
        remaining = sub_parts[i:]
        if loc.is_local():
            new_loc = Location.local(
                os.path.join(loc.target, *remaining)
                if remaining else loc.target)
        else:
            new_loc = loc
            for part in remaining:
                new_loc = new_loc.child(part)
        return ClusterLocation(self.kind, location=new_loc)

    async def list_cluster_locations(self, config
                                     ) -> AsyncIterator["ClusterLocation"]:
        async for entry in self.list_files_recursive(config):
            if entry.is_file():
                yield self.make_sub_location(entry.path)

    # ---- verify / resilver (cluster_location.rs:355-402) ----

    async def resilver(self, config):
        if self.kind == "cluster":
            cluster, profile = await self.get_cluster_with_profile(config)
            destination = cluster.get_destination(profile)
            file_ref = await cluster.get_file_ref(self.path)
            report = await file_ref.resilver(
                destination, backend=cluster.tunables.backend)
            await cluster.write_file_ref(self.path, file_ref)
            return report
        if self.kind == "file_ref":
            import json

            file_ref = await self._load_file_ref(config)
            destination = await config.get_default_destination()
            report = await file_ref.resilver(destination)
            await self.location.write(
                json.dumps(file_ref.to_obj(), indent=2).encode())
            return report
        raise ChunkyBitsError("Resilver is only supported on cluster files")

    async def verify(self, config):
        if self.kind in ("cluster", "file_ref"):
            file_ref = await self._load_file_ref(config)
            cx = None
            if self.kind == "cluster":
                cluster = await config.get_cluster(self.cluster)
                cx = cluster.tunables.location_context()
            return await file_ref.verify(cx)
        raise ChunkyBitsError("Verify is only supported on files")

    # ---- hashes (cluster_location.rs:404-515) ----

    async def get_hashes(self, config) -> list[AnyHash]:
        if self.kind in ("cluster", "file_ref"):
            file_ref = await self._load_file_ref(config)
            return [
                chunk.hash
                for part in file_ref.parts
                for chunk in part.data + part.parity
            ]
        # raw data: hash through the codec without storing
        d = await config.get_default_data_chunks()
        p = await config.get_default_parity_chunks()
        cs = await config.get_default_chunk_size()
        _warn_once(
            "hashes-binary",
            f"Warning: Hashes generated from binary data using data = {d}, "
            f"parity = {p}, chunk_size = 2^{cs}",
        )
        reader = await self.get_reader(config)
        try:
            file_ref = await (
                FileReference.write_builder()
                .with_data_chunks(d)
                .with_parity_chunks(p)
                .with_chunk_size(1 << cs)
                .write(reader)
            )
        finally:
            await aio.close_reader(reader)
        return [
            chunk.hash
            for part in file_ref.parts
            for chunk in part.data + part.parity
        ]

    async def _get_hashes_snapshot(self, metadata
                                   ) -> Optional[list[str]]:
        """Meta-log fast path for the liveness walk: every referenced
        hash under this location, in display form (``sha256-<hex>`` —
        both consumers of ``get_hashes_rec`` key on ``str(hash)``, so
        handing strings skips 10^5 ``AnyHash`` constructions per 10^4
        refs).  Tries the pure INDEX scan first (``namespace_hashes``:
        publish-time hash projections, zero ref reads, zero parses),
        then one ``namespace_snapshot()`` batch read+parse; either way
        no recursive listing and no per-file metadata round-trips.
        None when neither surface is available (the caller runs the
        legacy walk); per-ref parse failures on the snapshot path are
        surfaced on stderr and skipped, exactly like the legacy walk's
        per-file failures."""
        from chunky_bits_tpu_torch.cluster.meta_log import norm_name

        want = norm_name(self.path or "")
        prefix = want + "/" if want else ""

        def _mine(name: str) -> bool:
            return not prefix or name == want or name.startswith(prefix)

        index = getattr(metadata, "namespace_hashes", None)
        if index is not None:
            try:
                rows = await index()
            except ChunkyBitsError:
                rows = None
            if rows is not None:
                return [h for name, hashes in rows if _mine(name)
                        for h in hashes]
        try:
            entries = await metadata.namespace_snapshot()
        except ChunkyBitsError:
            # a poisoned batched read: the per-file walk isolates the
            # bad entry and surfaces it individually
            return None
        out: list[str] = []
        for name, obj in entries:
            if not _mine(name):
                continue
            try:
                ref = FileReference.from_obj(obj)
            except ChunkyBitsError as err:
                print(f"{self.cluster}#{name}: {err}", file=sys.stderr)
                continue
            for part in ref.parts:
                for chunk in part.data + part.parity:
                    out.append(str(chunk.hash))
        return out

    async def get_hashes_rec(self, config) -> AsyncIterator:
        """One task per file, mpsc fan-in (cluster_location.rs:478-515).
        Every per-file failure is surfaced on stderr — a swallowed error
        here could misclassify live chunks as garbage downstream.

        A cluster source over a meta-log metadata store short-circuits
        through ``_get_hashes_snapshot`` (an index scan, or one batched
        namespace read — no per-file tasks), which yields hash display
        STRINGS; the fan-in below is the universal path and yields
        ``AnyHash``.  Both consumers key on ``str(hash)``, which is
        identical either way."""
        if self.kind == "cluster":
            cluster = await config.get_cluster(self.cluster)
            if hasattr(cluster.metadata, "namespace_snapshot"):
                hashes = await self._get_hashes_snapshot(cluster.metadata)
                if hashes is not None:
                    for h in hashes:
                        yield h
                    return
        queue: asyncio.Queue = asyncio.Queue(50)
        tasks = []
        _DONE = object()

        async def hash_one(loc: "ClusterLocation") -> None:
            try:
                for h in await loc.get_hashes(config):
                    await queue.put(("ok", h))
            except Exception as err:  # noqa: BLE001 — must never swallow
                await queue.put(("err", f"{loc}: {err}"))

        async for loc in self.list_cluster_locations(config):
            tasks.append(asyncio.ensure_future(hash_one(loc)))

        async def watcher() -> None:
            await asyncio.gather(*tasks, return_exceptions=True)
            await queue.put(_DONE)

        pending = asyncio.ensure_future(watcher())
        try:
            while tasks:
                item = await queue.get()
                if item is _DONE:
                    break
                kind, value = item
                if kind == "ok":
                    yield value
                else:
                    print(value, file=sys.stderr)
        finally:
            await pending

    # ---- migrate (cluster_location.rs:517-620) ----

    async def get_file_reference(self, config, data: int, parity: int,
                                 chunk_size_log2: int) -> FileReference:
        """For ``other`` locations, build a reference whose data chunks are
        range-sliced views of the original file (no copy), with parity
        written through the normal path."""
        if self.kind == "cluster" or self.kind == "file_ref":
            return await self._load_file_ref(config)
        if self.kind != "other":
            raise ChunkyBitsError(f"Cannot get a file reference for {self}")
        location = self.location
        reader = await self.get_reader(config)
        try:
            file_ref = await (
                FileReference.write_builder()
                .with_data_chunks(data)
                .with_parity_chunks(parity)
                .with_chunk_size(1 << chunk_size_log2)
                .write(reader)
            )
        finally:
            await aio.close_reader(reader)
        bytes_seen = 0
        from chunky_bits_tpu_torch.file.location import Range

        last_chunk = None
        for part in file_ref.parts:
            for chunk in part.data:
                chunk.locations.append(location.with_range(
                    Range(bytes_seen, part.chunksize, False)))
                bytes_seen += part.chunksize
                last_chunk = chunk
        if last_chunk is not None:
            rng = last_chunk.locations[-1].range
            last_chunk.locations[-1] = last_chunk.locations[-1].with_range(
                Range(rng.start, rng.length, True))
        return file_ref

    async def migrate(self, config, destination: "ClusterLocation") -> None:
        import json

        if destination.kind == "cluster":
            cluster, profile = \
                await destination.get_cluster_with_profile(config)
            file_ref = await self.get_file_reference(
                config, profile.get_data_chunks(),
                profile.get_parity_chunks(), profile.chunk_size)
            await cluster.write_file_ref(destination.path, file_ref)
        elif destination.kind == "file_ref":
            file_ref = await self.get_file_reference(
                config,
                await config.get_default_data_chunks(),
                await config.get_default_parity_chunks(),
                await config.get_default_chunk_size())
            await destination.location.write(
                json.dumps(file_ref.to_obj(), indent=2).encode())
        else:
            raise ChunkyBitsError(f"Cannot migrate to {destination}")
