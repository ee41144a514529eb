"""The cluster façade: config-deserialized top level of the system (the
port of ``chunky_bits_tpu/cluster/cluster.py``).

Mirrors src/cluster/cluster.rs: ``{destinations, metadata, profiles,
tunables}`` with serde aliases (``nodes``/``node``/``destination``,
``tunable``/``tuning``; cluster.rs:43-56).  Builds write pipelines over the
placement engine, reads files back through the part codec, lists metadata.

The reference's ``get_file_writer`` forgets to set ``parity_chunks``
(cluster.rs:65-71 — profile parity is silently replaced by the library
default of 2); that bug is fixed here, matching the behavior of its own
``write_file_with_report`` (cluster.rs:109-113), per SURVEY §7.

On a device backend (``Tunables.is_device_backend``: ``cuda``, a
``cuda:<spec>`` mesh, ``mesh`` and their JAX-package spellings) concurrent
writes share one encode batcher per event loop, and every read shares one
reconstruct batcher per loop, so their parts reach the card in batched
dispatches.  With the ``cache_bytes`` tunable above 0 every read of a
loop also shares one content-addressed chunk cache
(``file/chunk_cache.py``), and parsed file references are cached,
fenced by every write of the same path.
"""

from __future__ import annotations

import asyncio
import threading
import weakref
from collections import OrderedDict
from typing import Optional, Union

from chunky_bits_tpu_torch.cluster.destination import Destination
from chunky_bits_tpu_torch.cluster.metadata import (
    FileOrDirectory,
    MetadataFormat,
    MetadataStore,
    metadata_from_obj,
)
from chunky_bits_tpu_torch.cluster.nodes import ClusterNodes
from chunky_bits_tpu_torch.cluster.profile import (ClusterProfile,
                                                   ClusterProfiles)
from chunky_bits_tpu_torch.cluster.tunables import Tunables
from chunky_bits_tpu_torch.errors import SerdeError
from chunky_bits_tpu_torch.file.file_reference import FileReference
from chunky_bits_tpu_torch.file.location import Location
from chunky_bits_tpu_torch.file.profiler import ProfileReport, new_profiler
from chunky_bits_tpu_torch.file.reader import FileReadBuilder
from chunky_bits_tpu_torch.file.writer import FileWriteBuilder
from chunky_bits_tpu_torch.utils import aio


class Cluster:
    def __init__(self, destinations: ClusterNodes,
                 metadata: MetadataStore,
                 profiles: ClusterProfiles,
                 tunables: Optional[Tunables] = None):
        self.destinations = destinations
        self.metadata = metadata
        self.profiles = profiles
        self.tunables = tunables or Tunables()
        # per-event-loop shared encode batchers (see _encode_batcher)
        self._encode_batchers = weakref.WeakKeyDictionary()
        # per-event-loop shared reconstruct batchers (see
        # _reconstruct_batcher)
        self._reconstruct_batchers = weakref.WeakKeyDictionary()
        # per-event-loop content-addressed chunk caches (see
        # _chunk_cache); only when tunables.cache_bytes > 0
        self._chunk_caches = weakref.WeakKeyDictionary()
        # parsed FileReference cache (only when caching is on): hot GETs
        # skip the metadata read + YAML parse.  Bounded LRU; every write
        # of a path invalidates it, and the generation counter keeps a
        # read that was in flight across a write from inserting the old
        # reference
        self._file_refs: "OrderedDict[str, FileReference]" = OrderedDict()
        self._file_ref_gen = 0
        # cluster-pinned host pipeline (tunables.host_threads > 0), else
        # the process-shared one (see host_pipeline()); the lock makes
        # first-use construction single — clusters are already used from
        # multiple event loops in different threads (see the per-loop
        # batcher maps), and a lost race would leak a worker set
        self._own_host_pipeline = None
        self._host_pipeline_lock = threading.Lock()
        # ONE location-health scoreboard per cluster (cluster/health.py)
        # shared across every loop and worker thread via the shared
        # LocationContext (unlike the per-loop batchers: health memory
        # must span loops, and it is thread-safe by construction).
        # Every read/write completion feeds it; hedged reads arm only
        # when `tunables.hedge_ms` > 0.
        from chunky_bits_tpu_torch.cluster.health import HealthScoreboard

        self._health = HealthScoreboard(hedge_ms=self.tunables.hedge_ms)
        self.tunables.location_context().health = self._health

    # ---- serde ----

    @classmethod
    def from_obj(cls, obj: dict) -> "Cluster":
        if not isinstance(obj, dict):
            raise SerdeError("cluster config must be a mapping")
        nodes_obj = None
        for key in ("destinations", "destination", "nodes", "node"):
            if key in obj:
                nodes_obj = obj[key]
                break
        if nodes_obj is None:
            raise SerdeError("cluster config missing destinations")
        meta_obj = obj.get("metadata")
        if meta_obj is None:
            raise SerdeError("cluster config missing metadata")
        if "profiles" not in obj:
            raise SerdeError("cluster config missing profiles")
        tunables_obj = None
        for key in ("tunables", "tunable", "tuning"):
            if key in obj:
                tunables_obj = obj[key]
                break
        return cls(
            destinations=ClusterNodes.from_obj(nodes_obj),
            metadata=metadata_from_obj(meta_obj),
            profiles=ClusterProfiles.from_obj(obj["profiles"]),
            tunables=Tunables.from_obj(tunables_obj),
        )

    def to_obj(self) -> dict:
        return {
            "destinations": self.destinations.to_obj(),
            "metadata": self.metadata.to_obj(),
            "profiles": self.profiles.to_obj(),
            "tunables": self.tunables.to_obj(),
        }

    @classmethod
    async def from_location(cls, location: Union[str, Location],
                            ) -> "Cluster":
        """Load cluster.yaml from any Location (cluster.rs:59-63)."""
        obj = await MetadataFormat("yaml").from_location(location)
        return cls.from_obj(obj)

    # ---- profiles ----

    def get_profile(self, name: Optional[str] = None
                    ) -> Optional[ClusterProfile]:
        return self.profiles.get(name)

    # ---- write path ----

    def get_destination(self, profile: ClusterProfile) -> Destination:
        return Destination(
            self.destinations, profile, self.tunables.location_context())

    def health_scoreboard(self):
        """The cluster's shared location-health scoreboard
        (cluster/health.py): EWMA latency, error rate, breaker state
        per storage node, plus the hedged-read budget/counters."""
        return self._health

    def get_destination_with_profiler(
        self, profile: ClusterProfile
    ) -> tuple[object, Destination]:
        profiler, reporter = new_profiler()
        # write reports carry the per-location health table alongside
        # the I/O log (the read path attaches it in read_buffers)
        profiler.attach_health(self._health)
        cx = self.tunables.location_context().but_with(profiler=profiler)
        return reporter, Destination(self.destinations, profile, cx)

    def _encode_batcher(self):
        """Per-event-loop shared EncodeHashBatcher so concurrent writes
        into this cluster (e.g. parallel gateway PUTs of small objects)
        coalesce into single device dispatches.  Device backends only:
        on the host backends the extra concatenate buys nothing."""
        if not self.tunables.is_device_backend():
            return None
        loop = asyncio.get_running_loop()
        batcher = self._encode_batchers.get(loop)
        if batcher is None:
            from chunky_bits_tpu_torch.ops.batching import EncodeHashBatcher

            batcher = EncodeHashBatcher(backend=self.tunables.backend,
                                        host_pipeline=self.host_pipeline())
            self._encode_batchers[loop] = batcher
        return batcher

    def host_pipeline(self):
        """This cluster's host compute executor (per-shard SHA-256 +
        per-stripe GF encode workers, parallel/host_pipeline.py): a
        cluster-pinned instance when ``tunables.host_threads`` is set in
        cluster.yaml, else the process-shared auto-sized pipeline.  Every
        ingest path of this cluster (write_file, gateway PUT) draws from
        it, so the thread budget is one knob, not per-call-site.  Known
        exception: a device backend's internal ingest hashing
        (``CudaBackend.encode_and_hash``, the mesh backends' staged
        hashing) runs on the backend's own threads or the process-shared
        pipeline, whose size ``$CHUNKY_BITS_TORCH_HOST_THREADS`` caps:
        backends have no cluster context to thread the pinned instance
        through."""
        from chunky_bits_tpu_torch.parallel.host_pipeline import (
            HostPipeline,
            get_host_pipeline,
        )

        n = self.tunables.host_threads
        if n <= 0:
            return get_host_pipeline()
        with self._host_pipeline_lock:
            if self._own_host_pipeline is None:
                self._own_host_pipeline = HostPipeline(threads=n)
            return self._own_host_pipeline

    def get_file_writer(self, profile: ClusterProfile) -> FileWriteBuilder:
        # Staging several parts per encode dispatch amortizes per-part
        # overhead for every backend: device backends save dispatches,
        # and the CPU backends save the per-part to_thread/orchestration
        # machinery (the writer's staging groups full parts as zero-copy
        # slices, so unlike the batcher's concatenate this costs no extra
        # memcpy).  Device backends additionally coalesce across
        # concurrent writes (shared encode batcher).
        batch_parts = 8
        return (
            FileWriteBuilder()
            .with_destination(self.get_destination(profile))
            .with_chunk_size(profile.get_chunk_size())
            .with_data_chunks(profile.get_data_chunks())
            # deliberate fix of the reference's missing parity setter
            .with_parity_chunks(profile.get_parity_chunks())
            .with_backend(self.tunables.backend)
            .with_batch_parts(batch_parts)
            .with_encode_batcher(self._encode_batcher)
            .with_host_pipeline(self.host_pipeline())
            .with_repair_block_bytes(self.tunables.repair_block_bytes)
            .with_code(profile.get_code())
        )

    async def write_file_ref(self, path: str,
                             file_ref: FileReference) -> None:
        # invalidate around both edges of the durable write: the bump
        # before it fences get_file_ref calls already parsing the old
        # bytes, the bump after it fences calls that started during the
        # write; either way a stale parse is never inserted
        self._file_ref_gen += 1
        self._file_refs.pop(path, None)
        try:
            await self.metadata.write(path, file_ref.to_obj())
        finally:
            self._file_ref_gen += 1
            self._file_refs.pop(path, None)

    async def write_file(self, path: str, reader: aio.AsyncByteReader,
                         profile: ClusterProfile,
                         content_type: Optional[str] = None) -> FileReference:
        file_ref = await self.get_file_writer(profile).write(reader)
        file_ref.content_type = content_type
        await self.write_file_ref(path, file_ref)
        return file_ref

    async def write_file_with_report(
        self, path: str, reader: aio.AsyncByteReader,
        profile: ClusterProfile, content_type: Optional[str] = None,
    ) -> tuple[ProfileReport, FileReference]:
        reporter, destination = self.get_destination_with_profiler(profile)
        file_ref = await (
            self.get_file_writer(profile)
            .with_destination(destination)
            .write(reader)
        )
        file_ref.content_type = content_type
        await self.write_file_ref(path, file_ref)
        return reporter.profile(), file_ref

    # ---- read path ----

    #: FileReference cache bound (entries, not bytes: a parsed reference
    #: is tiny next to the chunk buffers the byte budget governs)
    FILE_REF_CACHE_ENTRIES = 1024

    def _reconstruct_batcher(self):
        """Per-event-loop shared ReconstructBatcher, mirroring
        ``_encode_batcher``: concurrent degraded GETs (and resilver-like
        readers) coalesce into single batched reconstruct dispatches
        instead of one batcher per read stream.  Shared for every
        backend, and never aclosed: it owns no OS resources, and its
        in-flight dispatch tasks finish with the reads that await them."""
        loop = asyncio.get_running_loop()
        batcher = self._reconstruct_batchers.get(loop)
        if batcher is None:
            from chunky_bits_tpu_torch.ops.batching import ReconstructBatcher

            batcher = ReconstructBatcher(backend=self.tunables.backend)
            self._reconstruct_batchers[loop] = batcher
        return batcher

    def _chunk_cache(self):
        """Per-event-loop content-addressed read cache, or None when the
        ``cache_bytes`` tunable leaves it off (the default)."""
        if self.tunables.cache_bytes <= 0:
            return None
        loop = asyncio.get_running_loop()
        cache = self._chunk_caches.get(loop)
        if cache is None:
            from chunky_bits_tpu_torch.file.chunk_cache import ChunkCache

            cache = ChunkCache(self.tunables.cache_bytes)
            self._chunk_caches[loop] = cache
        return cache

    async def get_file_ref(self, path: str) -> FileReference:
        cache_on = self.tunables.cache_bytes > 0
        if cache_on:
            ref = self._file_refs.get(path)
            if ref is not None:
                self._file_refs.move_to_end(path)
                return ref
        gen = self._file_ref_gen
        ref = FileReference.from_obj(await self.metadata.read(path))
        # insert only if no write invalidated the cache while this read
        # was in flight, or a stale reference would stay cached
        if cache_on and gen == self._file_ref_gen:
            self._file_refs[path] = ref
            while len(self._file_refs) > self.FILE_REF_CACHE_ENTRIES:
                self._file_refs.popitem(last=False)
        return ref

    def file_read_builder(self, file_ref: FileReference) -> FileReadBuilder:
        """The serve-path read builder: cluster context, backend, the
        per-loop shared reconstruct batcher, the cluster's host pipeline
        and (when enabled) the chunk cache.  The gateway, ``read_file``
        and the CLI come through here so every read shares the same
        coalescing and cache."""
        return (
            file_ref.read_builder(self.tunables.location_context())
            .with_backend(self.tunables.backend)
            .with_batcher(self._reconstruct_batcher())
            .with_cache(self._chunk_cache())
            .with_pipeline(self.host_pipeline())
        )

    async def read_file(self, path: str) -> aio.AsyncByteReader:
        file_ref = await self.get_file_ref(path)
        return self.file_read_builder(file_ref).reader()

    async def list_files(self, path: str = ".") -> list[FileOrDirectory]:
        return await self.metadata.list(path)
