"""Config-declared default destination (the port of
``chunky_bits_tpu/cli/any_destination.py``).

Mirrors src/bin/chunky-bits/any_destination.rs:33-156: ``type: cluster``
(named cluster + profile), ``type: locations`` (weighted location list with
inline d/p/chunk-size), or ``type: void`` (the default — discard).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from chunky_bits_tpu_torch.cluster import sized_int
from chunky_bits_tpu_torch.errors import ChunkyBitsError, SerdeError
from chunky_bits_tpu_torch.file import (
    VoidDestination,
    WeightedLocation,
    WeightedLocationsDestination,
)


@dataclass
class AnyDestinationRef:
    type: str = "void"  # "cluster" | "locations" | "void"
    cluster: Optional[str] = None
    profile: Optional[str] = None
    data: int = sized_int.DATA_DEFAULT
    parity: int = sized_int.PARITY_DEFAULT
    chunk_size: int = sized_int.CHUNK_SIZE_DEFAULT
    locations: list[WeightedLocation] = field(default_factory=list)

    def is_void(self) -> bool:
        return self.type == "void"

    @classmethod
    def from_obj(cls, obj) -> "AnyDestinationRef":
        if obj is None:
            return cls()
        if not isinstance(obj, dict) or "type" not in obj:
            raise SerdeError("destination must be a mapping with 'type'")
        kind = obj["type"]
        if kind == "cluster":
            if "cluster" not in obj:
                raise SerdeError("cluster destination missing 'cluster'")
            return cls(type="cluster", cluster=obj["cluster"],
                       profile=obj.get("profile"))
        if kind in ("locations", "void"):
            out = cls(type=kind)
            if "data" in obj:
                out.data = sized_int.data_chunk_count(obj["data"])
            if "parity" in obj:
                out.parity = sized_int.parity_chunk_count(obj["parity"])
            if "chunk_size" in obj:
                out.chunk_size = sized_int.chunk_size(obj["chunk_size"])
            if kind == "locations":
                out.locations = [WeightedLocation.from_obj(o)
                                 for o in obj.get("locations", [])]
            return out
        raise SerdeError(f"unknown destination type {kind!r}")

    def to_obj(self) -> dict:
        if self.type == "cluster":
            return {"type": "cluster", "cluster": self.cluster,
                    "profile": self.profile}
        obj = {"type": self.type, "data": self.data,
               "parity": self.parity, "chunk_size": self.chunk_size}
        if self.type == "locations":
            obj["locations"] = [wl.to_obj() for wl in self.locations]
        return obj

    async def get_destination(self, config):
        if self.type == "cluster":
            cluster = await config.get_cluster(self.cluster)
            profile_name = self.profile
            if profile_name is None:
                profile_name = config.get_profile(self.cluster)
            profile = cluster.get_profile(profile_name)
            if profile is None:
                raise ChunkyBitsError(f"Profile not found: {profile_name}")
            return cluster.get_destination(profile)
        if self.type == "locations":
            return WeightedLocationsDestination(self.locations)
        return VoidDestination()
