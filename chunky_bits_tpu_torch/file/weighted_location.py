"""A location with a placement weight; parses ``"750:/path"`` prefix syntax
(the port of ``chunky_bits_tpu/file/weighted_location.py``; default
weight 1000)."""

from __future__ import annotations

from dataclasses import dataclass

from chunky_bits_tpu_torch.file.location import Location

DEFAULT_WEIGHT = 1000


@dataclass
class WeightedLocation:
    location: Location
    weight: int = DEFAULT_WEIGHT

    @classmethod
    def parse(cls, s: str) -> "WeightedLocation":
        prefix, sep, postfix = s.partition(":")
        if sep and prefix.isdigit():
            return cls(location=Location.parse(postfix), weight=int(prefix))
        return cls(location=Location.parse(s))

    @classmethod
    def from_obj(cls, obj) -> "WeightedLocation":
        if isinstance(obj, str):
            return cls.parse(obj)
        return cls(
            location=Location.parse(obj["location"]),
            weight=int(obj.get("weight", DEFAULT_WEIGHT)),
        )

    def to_obj(self) -> dict:
        return {"weight": self.weight, "location": str(self.location)}
