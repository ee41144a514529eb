"""Node inventory with zone tagging (the port of
``chunky_bits_tpu/cluster/nodes.py``).

Mirrors src/cluster/nodes.rs: a ``ClusterNode`` is a flattened
WeightedLocation plus a zone set and a ``repeat`` count (extra placement
slots, :65-73).  The deserializer accepts a single node, a list, or a map of
zone-name -> nodes — map members are auto-tagged with the zone name,
recursively (:26-63).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from chunky_bits_tpu_torch.errors import SerdeError
from chunky_bits_tpu_torch.file.weighted_location import (
    WeightedLocation,
)


@dataclass
class ClusterNode:
    location: WeightedLocation
    zones: set[str] = field(default_factory=set)
    repeat: int = 0

    @classmethod
    def from_obj(cls, obj) -> "ClusterNode":
        if isinstance(obj, str):
            return cls(location=WeightedLocation.parse(obj))
        if not isinstance(obj, dict) or "location" not in obj:
            raise SerdeError(f"invalid cluster node: {obj!r}")
        return cls(
            location=WeightedLocation.from_obj(obj),
            zones=set(obj.get("zones", []) or []),
            repeat=int(obj.get("repeat", 0) or 0),
        )

    def to_obj(self) -> dict:
        obj = {
            "weight": self.location.weight,
            "location": str(self.location.location),
        }
        if self.zones:
            obj["zones"] = sorted(self.zones)
        if self.repeat:
            obj["repeat"] = self.repeat
        return obj


class ClusterNodes:
    def __init__(self, nodes: list[ClusterNode]):
        self.nodes = nodes

    def __iter__(self):
        return iter(self.nodes)

    def __len__(self) -> int:
        return len(self.nodes)

    def __getitem__(self, i: int) -> ClusterNode:
        return self.nodes[i]

    @classmethod
    def from_obj(cls, obj) -> "ClusterNodes":
        return cls(cls._flatten(obj))

    @staticmethod
    def _flatten(obj) -> list[ClusterNode]:
        """Single / list / zone-map flattening (nodes.rs:26-63)."""
        if isinstance(obj, list):
            out: list[ClusterNode] = []
            for sub in obj:
                out.extend(ClusterNodes._flatten(sub))
            return out
        if isinstance(obj, dict) and "location" not in obj:
            out = []
            for zone_name, sub in sorted(obj.items()):
                for node in ClusterNodes._flatten(sub):
                    node.zones.add(zone_name)
                    out.append(node)
            return out
        return [ClusterNode.from_obj(obj)]

    def to_obj(self) -> list:
        return [n.to_obj() for n in self.nodes]

    def total_slots(self) -> int:
        """Placement capacity: sum of repeat+1
        (src/cluster/destination.rs:69-72)."""
        return sum(node.repeat + 1 for node in self.nodes)
