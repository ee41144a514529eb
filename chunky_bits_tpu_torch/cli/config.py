"""User configuration: named clusters and defaults (the port of
``chunky_bits_tpu/cli/config.py``).

Mirrors src/bin/chunky-bits/config.rs: default path ``/etc/chunky-bits.yaml``
(missing file tolerated unless ``--config`` was given, :231-249); named
clusters inline or by-location (:65-70); per-cluster + global
``default_profile``; an async cluster cache (:54-56,77-111); default
d/p/chunk-size resolved through the default destination (:146-188); CLI-flag
overlay (:252-290).
"""

from __future__ import annotations

import asyncio
from typing import Optional

import yaml

from chunky_bits_tpu_torch.cli.any_destination import AnyDestinationRef
from chunky_bits_tpu_torch.cluster import Cluster, ClusterProfile, sized_int
from chunky_bits_tpu_torch.errors import ChunkyBitsError, SerdeError
from chunky_bits_tpu_torch.utils.yamlio import yaml_load

DEFAULT_CONFIG_PATH = "/etc/chunky-bits.yaml"
_KNOWN_FIELDS = {"clusters", "default_destination", "default_profile"}


class Config:
    def __init__(self, clusters: Optional[dict] = None,
                 default_destination: Optional[AnyDestinationRef] = None,
                 default_profile: Optional[str] = None):
        # clusters: name -> {"cluster": Cluster|Location-str,
        #                    "default_profile": Optional[str]}
        self.clusters = clusters or {}
        self.default_destination = default_destination or AnyDestinationRef()
        self.default_profile = default_profile
        self._cache: dict[str, Cluster] = {}
        self._cache_lock = asyncio.Lock()

    async def aclose(self) -> None:
        """Close every cached cluster's HTTP session of the running loop
        (the reference's reqwest clients drop implicitly; aiohttp wants
        an explicit close or it warns at interpreter exit)."""
        async with self._cache_lock:
            clusters = list(self._cache.values())
        for cluster in clusters:
            await cluster.tunables.location_context().aclose()

    # ---- loading ----

    @classmethod
    def from_obj(cls, obj: dict) -> "Config":
        if not isinstance(obj, dict):
            raise SerdeError("config must be a mapping")
        unknown = set(obj) - _KNOWN_FIELDS
        if unknown:
            raise SerdeError(f"unknown config fields: {sorted(unknown)}")
        clusters = {}
        for name, spec in (obj.get("clusters") or {}).items():
            if not isinstance(spec, dict):
                raise SerdeError(f"cluster {name!r} must be a mapping")
            if "location" in spec:
                cluster = spec["location"]  # lazy: load on first use
            elif "inline" in spec:
                cluster = Cluster.from_obj(spec["inline"])
            else:
                raise SerdeError(
                    f"cluster {name!r} needs 'inline' or 'location'")
            clusters[name] = {
                "cluster": cluster,
                "default_profile": spec.get("default_profile"),
            }
        return cls(
            clusters=clusters,
            default_destination=AnyDestinationRef.from_obj(
                obj.get("default_destination")),
            default_profile=obj.get("default_profile"),
        )

    @classmethod
    async def load(cls, path: Optional[str] = None) -> "Config":
        target = path or DEFAULT_CONFIG_PATH

        def _read() -> bytes:
            with open(target, "rb") as f:
                return f.read()

        data = await asyncio.to_thread(_read)
        try:
            obj = yaml_load(data)
        except yaml.YAMLError as err:
            raise SerdeError(f"invalid config {target}: {err}") from err
        return cls.from_obj(obj or {})

    @classmethod
    async def load_or_default(cls, path: Optional[str] = None,
                              chunk_size: Optional[int] = None,
                              data_chunks: Optional[int] = None,
                              parity_chunks: Optional[int] = None
                              ) -> "Config":
        """Load, tolerating a missing default config; then overlay CLI
        flags over the default destination's geometry."""
        if path is not None:
            try:
                config = await cls.load(path)
            except OSError as err:
                raise ChunkyBitsError(
                    f"cannot read config {path}: {err}") from err
        else:
            try:
                config = await cls.load(None)
            except (OSError, SerdeError):
                config = cls()
        dest = config.default_destination
        if dest.type in ("void", "locations"):
            if chunk_size is not None:
                dest.chunk_size = sized_int.chunk_size(chunk_size)
            if data_chunks is not None:
                dest.data = sized_int.data_chunk_count(data_chunks)
            if parity_chunks is not None:
                dest.parity = sized_int.parity_chunk_count(parity_chunks)
        return config

    def to_obj(self) -> dict:
        clusters = {}
        for name, spec in self.clusters.items():
            cluster = spec["cluster"]
            if isinstance(cluster, Cluster):
                entry: dict = {"inline": cluster.to_obj()}
            else:
                entry = {"location": str(cluster)}
            if spec.get("default_profile"):
                entry["default_profile"] = spec["default_profile"]
            clusters[name] = entry
        return {
            "clusters": clusters,
            "default_destination": self.default_destination.to_obj(),
            "default_profile": self.default_profile,
        }

    # ---- cluster resolution (config.rs:77-111) ----

    async def get_cluster(self, target: str) -> Cluster:
        async with self._cache_lock:
            if target in self._cache:
                return self._cache[target]
        is_local_name = all(
            c in "_-" or c.isascii() and c.isalnum() for c in target
        )
        if is_local_name:
            spec = self.clusters.get(target)
            if spec is None:
                raise ChunkyBitsError(
                    f"Cluster not defined in configuration: {target}")
            cluster = spec["cluster"]
            if not isinstance(cluster, Cluster):
                cluster = await Cluster.from_location(str(cluster))
        else:
            cluster = await Cluster.from_location(target)
        async with self._cache_lock:
            self._cache[target] = cluster
        return cluster

    def get_profile(self, target: str) -> Optional[str]:
        spec = self.clusters.get(target)
        if spec is not None and spec.get("default_profile"):
            return spec["default_profile"]
        return self.default_profile

    # ---- defaults through the destination ref (config.rs:120-188) ----

    async def get_default_destination(self):
        destination = await self.default_destination.get_destination(self)
        if self.default_destination.is_void():
            import sys

            print("Warning: Using void destination", file=sys.stderr)
        return destination

    async def _default_cluster_profile(self) -> ClusterProfile:
        ref = self.default_destination
        cluster = await self.get_cluster(ref.cluster)
        name = ref.profile if ref.profile is not None \
            else self.get_profile(ref.cluster)
        profile = cluster.get_profile(name)
        if profile is None:
            profile = cluster.get_profile(None)
        return profile

    async def get_default_chunk_size(self) -> int:
        if self.default_destination.type == "cluster":
            return (await self._default_cluster_profile()).chunk_size
        return self.default_destination.chunk_size

    async def get_default_data_chunks(self) -> int:
        if self.default_destination.type == "cluster":
            return (await self._default_cluster_profile()).data_chunks
        return self.default_destination.data

    async def get_default_parity_chunks(self) -> int:
        if self.default_destination.type == "cluster":
            return (await self._default_cluster_profile()).parity_chunks
        return self.default_destination.parity
