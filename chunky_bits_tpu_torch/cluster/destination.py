"""Cluster placement engine: zone-constrained, weighted, hash-seeded,
failure-tolerant shard placement (the port of
``chunky_bits_tpu/cluster/destination.py``).

Mirrors src/cluster/destination.rs + src/cluster/writer.rs:

* capacity check ``sum(repeat+1) >= count`` (destination.rs:69-72);
* shared writer state: per-node availability, failed nodes, zone budgets,
  error list, one hash-seeded RNG (destination.rs:73-84);
* resilver pre-pass removes availability from nodes already holding the
  part's other shards (destination.rs:85-94);
* writers are chained: writer i waits <=100 ms for writer i-1's first
  placement decision (destination.rs:100-113, writer.rs:245-252);
* ``next_writer`` draws a weighted random node honoring zone rules, RNG
  seeded from the first shard hash for deterministic placement
  (writer.rs:59-97);
* on write failure the node is invalidated, zone budgets are re-inflated,
  and a new node is drawn — loop until success or exhaustion
  (writer.rs:99-122,254-276).

One deliberate deviation: the reference's "banned zone" filter keeps *only*
nodes inside zones whose ``maximum`` budget is exhausted
(writer.rs:167-175), which inverts the evident intent; here nodes in
exhausted zones are excluded.  Zone rules are untested in the reference
(SURVEY §4); they are tested here.
"""

from __future__ import annotations

import asyncio
import random
from typing import Optional, Sequence

from chunky_bits_tpu_torch.cluster import clock as _clock
from chunky_bits_tpu_torch.cluster.nodes import ClusterNode, ClusterNodes
from chunky_bits_tpu_torch.cluster.profile import ClusterProfile, ZoneRule
from chunky_bits_tpu_torch.cluster.tunables import stagger_seconds
from chunky_bits_tpu_torch.errors import (
    NotEnoughAvailability,
    NotEnoughWriters,
    ShardError,
    is_transient_error,
)
from chunky_bits_tpu_torch.file.hashing import AnyHash
from chunky_bits_tpu_torch.file.location import Location, LocationContext

#: default writer stagger (writer.rs:246 pins 100 ms); the live value
#: is read through ``tunables.stagger_seconds()`` at each write so the
#: knob is env-tunable like every other
STAGGER_SECONDS = 0.1


class _WriterState:
    """Shared placement state (writer.rs:47-57)."""

    def __init__(self, nodes: ClusterNodes, profile: ClusterProfile,
                 cx: LocationContext):
        self.nodes = nodes
        self.cx = cx
        self.lock = asyncio.Lock()
        self.available: dict[int, int] = {
            i: node.repeat + 1 for i, node in enumerate(nodes)
        }
        self.failed: set[int] = set()
        self.zone_status: dict[str, ZoneRule] = {
            zone: rule.copy() for zone, rule in profile.zone_rules.items()
        }
        self.errors: list[ShardError] = []
        self.rng: Optional[random.Random] = None

    # -- zone filtering (writer.rs:125-199); precedence required > banned >
    #    ideal --

    def _eligible(self) -> list[tuple[int, ClusterNode]]:
        required = {z for z, r in self.zone_status.items() if r.minimum > 0}
        banned = {z for z, r in self.zone_status.items()
                  if r.maximum is not None and r.maximum <= 0}
        ideal = {z for z, r in self.zone_status.items() if r.ideal > 0}
        out = []
        for i, node in enumerate(self.nodes):
            if required:
                if not (node.zones & required):
                    continue
            elif banned:
                if node.zones & banned:  # deviation: exclude exhausted zones
                    continue
            elif ideal:
                if not (node.zones & ideal):
                    continue
            if i in self.failed:
                continue
            if self.available.get(i, 0) >= 1:
                out.append((i, node))
        return out

    def _remove_availability(self, index: int, node: ClusterNode) -> None:
        """Decrement node slot + zone budgets (writer.rs:201-219)."""
        self.available[index] -= 1
        for zone in node.zones:
            rule = self.zone_status.get(zone)
            if rule is not None:
                rule.ideal -= 1
                rule.minimum -= 1
                if rule.maximum is not None:
                    rule.maximum -= 1

    def _prefer_healthy(self, eligible: list[tuple[int, ClusterNode]]
                        ) -> list[tuple[int, ClusterNode]]:
        """Health-aware placement: de-prioritize nodes the scoreboard
        (cluster/health.py, via the shared LocationContext) marks
        degraded — open/half-open breaker or error-EWMA past the
        threshold — BEFORE they hard-fail a write.  Degraded nodes stay
        eligible as a last resort (capacity beats latency when nothing
        healthy remains), and with no health data the draw is
        byte-identical to the reference's (writer.rs:59-97)."""
        health = self.cx.health
        if health is None:
            return eligible
        preferred = [(i, n) for i, n in eligible
                     if not health.degraded(n.location.location)]
        if preferred and sum(n.location.weight
                             for _i, n in preferred) > 0:
            return preferred
        return eligible

    async def next_writer(self, hash_: AnyHash
                          ) -> tuple[int, ClusterNode]:
        async with self.lock:
            if not any(v > 0 for v in self.available.values()):
                raise self._pop_error()
            eligible = self._prefer_healthy(self._eligible())
            total_weight = sum(n.location.weight for _i, n in eligible)
            if total_weight == 0:
                raise self._pop_error()
            if self.rng is None:
                # Deterministic placement, seeded from the first shard's
                # hash (writer.rs:80-85).
                self.rng = random.Random(hash_.value.digest)
            sample = self.rng.randrange(total_weight)
            current = 0
            for index, node in eligible:
                current += node.location.weight
                if current > sample:
                    self._remove_availability(index, node)
                    return index, node
            raise AssertionError("invalid writer sample")

    def _pop_error(self) -> ShardError:
        if self.errors:
            return self.errors.pop()
        return NotEnoughAvailability()

    async def invalidate_index(self, index: int, err: ShardError) -> None:
        """Mark a node failed and re-inflate its zones' budgets
        (writer.rs:99-122)."""
        async with self.lock:
            self.failed.add(index)
            self.errors.append(err)
            if 0 <= index < len(self.nodes):
                for zone in self.nodes[index].zones:
                    rule = self.zone_status.get(zone)
                    if rule is not None:
                        rule.minimum += 1
                        if rule.maximum is not None:
                            rule.maximum += 1


class ClusterWriter:
    """Per-shard placement + retry engine (writer.rs:222-277)."""

    def __init__(self, state: _WriterState,
                 waiter: Optional[asyncio.Event],
                 staller: Optional[asyncio.Event]):
        self.state = state
        self.waiter = waiter
        self.staller = staller

    async def write_shard(self, hash_: AnyHash, data: bytes
                          ) -> list[Location]:
        # Stagger parity (writer.rs:246): writer i waits at most the
        # stagger window for writer i-1's FIRST placement decision, so
        # concurrent shard writers of one part serialize their initial
        # draws (deterministic seeded placement) without ever blocking
        # on a stuck sibling.  The 100 ms reference constant is the
        # default of the `tunables.stagger_seconds()` knob
        # ($CHUNKY_BITS_TORCH_STAGGER_SECONDS).
        if self.waiter is not None:
            waiter, self.waiter = self.waiter, None
            try:
                await asyncio.wait_for(
                    waiter.wait(), stagger_seconds(default=STAGGER_SECONDS))
            except asyncio.TimeoutError:
                pass
        while True:
            try:
                index, node = await self.state.next_writer(hash_)
            finally:
                if self.staller is not None:
                    self.staller.set()
                    self.staller = None
            # Transient HTTP failures (408/429/5xx minus 507) get up to
            # `tunables.read_retries` jittered-backoff retries against
            # the SAME node before it is invalidated — the reference
            # invalidates on the first error (writer.rs:99-122), which
            # ejects a briefly-overloaded node from the whole part.
            attempt = 0
            while True:
                try:
                    location = await node.location.location.write_subfile(
                        str(hash_), data, self.state.cx)
                except ShardError as err:
                    if attempt < self.state.cx.read_retries \
                            and is_transient_error(err):
                        attempt += 1
                        await _clock.sleep(
                            random.uniform(0.025, 0.075) * attempt)
                        continue
                    await self.state.invalidate_index(index, err)
                    break  # draw a different node
                else:
                    return [location]


class Destination:
    """CollectionDestination over a cluster (destination.rs:33-115)."""

    def __init__(self, nodes: ClusterNodes, profile: ClusterProfile,
                 cx: LocationContext):
        self.nodes = nodes
        self.profile = profile
        self.cx = cx

    def get_context(self) -> LocationContext:
        return self.cx

    def with_conflict_overwrite(self) -> "Destination":
        """A copy whose writes overwrite existing files — used by resilver
        so repairs can replace corrupt chunk files in place."""
        from chunky_bits_tpu_torch.file.location import OVERWRITE

        return Destination(
            self.nodes, self.profile,
            self.cx.but_with(on_conflict=OVERWRITE))

    def get_writers(self, count: int) -> list[ClusterWriter]:
        return self.get_used_writers([None] * count)

    def get_used_writers(self, locations: Sequence[Optional[Location]]
                         ) -> list[ClusterWriter]:
        count = sum(1 for loc in locations if loc is None)
        if self.nodes.total_slots() < count:
            raise NotEnoughWriters(
                f"cluster has {self.nodes.total_slots()} slots, "
                f"need {count}"
            )
        state = _WriterState(self.nodes, self.profile, self.cx)
        # Nodes already holding one of the part's shards are not eligible
        # for its missing shards (destination.rs:85-94).
        for location in locations:
            if location is None:
                continue
            for index, node in enumerate(self.nodes):
                if node.location.location.is_parent_of(location):
                    state._remove_availability(index, node)
        writers: list[ClusterWriter] = []
        prev_event: Optional[asyncio.Event] = None
        for _ in range(count):
            own_event = asyncio.Event()
            writers.append(ClusterWriter(state, prev_event, own_event))
            prev_event = own_event
        return writers
