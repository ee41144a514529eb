"""Placement abstraction: destinations hand out per-shard writers (the
port of ``chunky_bits_tpu/file/collection_destination.py``).

``get_writers(count)`` for fresh writes, ``get_used_writers(existing)``
for resilver (writers only for the missing slots), and
``write_shard(hash, bytes) -> [Location]``.  Implementations: weighted
location lists (random weighted sample without replacement), plain
location lists (first-N), and the void destination (discard: hash and
measure without storing).  The cluster-aware destination comes with the
cluster plane.
"""

from __future__ import annotations

import random
from typing import Optional, Protocol, Sequence, runtime_checkable

from chunky_bits_tpu_torch.errors import NotEnoughWriters
from chunky_bits_tpu_torch.file.hashing import AnyHash
from chunky_bits_tpu_torch.file.location import Location, LocationContext
from chunky_bits_tpu_torch.file.weighted_location import WeightedLocation


@runtime_checkable
class ShardWriter(Protocol):
    async def write_shard(self, hash_: AnyHash, data: bytes
                          ) -> list[Location]:  # pragma: no cover
        ...


class CollectionDestination(Protocol):
    def get_writers(self, count: int) -> list[ShardWriter]:  # pragma: no cover
        ...

    def get_used_writers(
        self, locations: Sequence[Optional[Location]]
    ) -> list[ShardWriter]:
        ...

    def get_context(self) -> LocationContext:
        ...


class _LocationWriter:
    """Binds a Location and a context into a ShardWriter."""

    def __init__(self, location: Location, cx: Optional[LocationContext]):
        self.location = location
        self.cx = cx

    async def write_shard(self, hash_: AnyHash, data: bytes) -> list[Location]:
        loc = await self.location.write_subfile(str(hash_), data, self.cx)
        return [loc]


class _BaseDestination:
    """Shared default implementations (collection_destination.rs:27-36)."""

    def get_used_writers(
        self, locations: Sequence[Optional[Location]]
    ) -> list[ShardWriter]:
        # Writers are needed for the *missing* (None) slots.  The reference's
        # default trait impl counts the present slots instead
        # (collection_destination.rs:30-35) — an inversion its own cluster
        # Destination does not share (destination.rs:62); the sane count is
        # used here.
        needed = sum(1 for loc in locations if loc is None)
        return self.get_writers(needed)

    def get_context(self) -> LocationContext:
        return LocationContext()


class WeightedLocationsDestination(_BaseDestination):
    """Weighted random sample without replacement
    (collection_destination.rs:56-73)."""

    def __init__(self, locations: Sequence[WeightedLocation],
                 cx: Optional[LocationContext] = None):
        self.locations = list(locations)
        self.cx = cx

    def get_writers(self, count: int) -> list[ShardWriter]:
        if len(self.locations) < count:
            raise NotEnoughWriters(
                f"need {count} writers, have {len(self.locations)}"
            )
        pool = list(self.locations)
        rng = random.Random()
        picked: list[ShardWriter] = []
        for _ in range(count):
            weights = [max(wl.weight, 0) for wl in pool]
            total = sum(weights)
            if total <= 0:
                # all-zero weights: fall back to uniform
                idx = rng.randrange(len(pool))
            else:
                idx = rng.choices(range(len(pool)), weights=weights, k=1)[0]
            picked.append(_LocationWriter(pool.pop(idx).location, self.cx))
        return picked


class LocationsDestination(_BaseDestination):
    """First-N placement over a plain location list
    (collection_destination.rs:75-84)."""

    def __init__(self, locations: Sequence[Location],
                 cx: Optional[LocationContext] = None):
        self.locations = [loc if isinstance(loc, Location)
                          else Location.parse(str(loc)) for loc in locations]
        self.cx = cx

    def get_writers(self, count: int) -> list[ShardWriter]:
        if len(self.locations) < count:
            raise NotEnoughWriters(
                f"need {count} writers, have {len(self.locations)}"
            )
        return [_LocationWriter(loc, self.cx)
                for loc in self.locations[:count]]


def as_destination(obj) -> "CollectionDestination":
    """Coerce the shapes the reference accepts as destinations: a
    CollectionDestination passes through; a list of WeightedLocations
    becomes weighted sampling (collection_destination.rs:56-73); a list
    of Locations (or location strings) becomes first-N placement
    (collection_destination.rs:75-84); None becomes the void (the
    builder's default, like the reference's ``()`` unit destination).

    An *empty* collection is a LocationsDestination that raises
    NotEnoughWriters on use — never a silent discard; mixing weighted
    and unweighted entries is a type error rather than a repr-parse."""
    if obj is None:
        return VoidDestination()
    if isinstance(obj, (list, tuple)):
        n_weighted = sum(isinstance(x, WeightedLocation) for x in obj)
        if n_weighted and n_weighted != len(obj):
            raise TypeError(
                "destination list mixes WeightedLocation with plain "
                "locations; use one or the other")
        if obj and n_weighted == len(obj):
            return WeightedLocationsDestination(list(obj))
        return LocationsDestination(list(obj))
    return obj


class _VoidWriter:
    async def write_shard(self, hash_: AnyHash, data: bytes) -> list[Location]:
        return []


class VoidDestination(_BaseDestination):
    """Sends shards to the void; used to test/measure the codec without
    storage (collection_destination.rs:113-132)."""

    def get_writers(self, count: int) -> list[ShardWriter]:
        return [_VoidWriter() for _ in range(count)]
