"""The fault-injection node plane (the port of
``chunky_bits_tpu/sim/fabric.py``): simulated storage nodes behind the
``Location`` surface.

A :class:`SimFabric` is a set of in-process storage nodes addressed as
``sim:<fabric>/<node>/<chunk>`` locations — the same lazy-dispatch
trick as ``slab:`` (``file/location.py`` imports this module only
inside its ``sim:`` branches, so production paths never load it).
Chunk bytes live in per-node dicts; every verb charges a
**distribution-driven virtual latency** (lognormal body + configurable
tail — the shape Dean & Barroso's "The Tail at Scale" hedging exists
for), **byte-accounted virtual bandwidth** (transfer seconds =
bytes / node bandwidth), and the node's **fault state machine**:

    healthy → slow → erroring → partitioned → dead → recovering → healthy

with any state reachable from any other (a scenario script is the
operator; the machine validates only that the *name* is known).  The
semantics per state:

* ``healthy``     — model latency, full service.
* ``slow``        — latency × ``slow_factor`` (config 8's one-slow-node
  generalized; the hedged-read straggler).
* ``erroring``    — latency, then a transient HTTP-status error
  (``error_status``, default 503 — the retry/breaker feeder).
* ``partitioned`` — the request stalls ``partition_stall_s`` of
  virtual time, then times out (an unreachable peer, not a refused
  one).
* ``dead``        — immediate connection-refused error (process gone).
* ``recovering``  — serves with latency × ``recover_factor``; lapses
  to ``healthy`` after ``recover_s`` of virtual time (computed lazily
  from the clock seam — no timer to leak).

Latency samples come from a per-node ``random.Random`` seeded from
``(fabric seed, node id)``, so a scenario replays byte-identically
under the virtual loop: same seed ⇒ same sample sequence ⇒ same trace
(pinned by tests/test_torch_sim.py).

Health integration costs nothing: ``cluster/health.py`` keys non-http
locations by ``os.path.dirname(target)``, which for
``<fabric>/<node>/<chunk>`` is exactly the node — the scoreboard,
breaker and hedge machinery see sim nodes as first-class peers.

:class:`FaultInjector` is the injection core of a scripted node: the
one-shot ``put_fail_status`` / ``get_delay`` knobs a real-socket fake node
exposes, as one model.
"""

from __future__ import annotations

import math
import random
import threading
from typing import Callable, Optional

from chunky_bits_tpu_torch.errors import HttpStatusError, LocationError
from chunky_bits_tpu_torch.utils import clock as _clock

__all__ = [
    "DEAD",
    "ERRORING",
    "HEALTHY",
    "PARTITIONED",
    "RECOVERING",
    "SLOW",
    "STATES",
    "FaultInjector",
    "LatencyModel",
    "SimFabric",
    "SimNode",
    "get_fabric",
    "resolve",
]

# ---- fault states ----

HEALTHY = "healthy"
SLOW = "slow"
ERRORING = "erroring"
PARTITIONED = "partitioned"
DEAD = "dead"
RECOVERING = "recovering"

STATES = (HEALTHY, SLOW, ERRORING, PARTITIONED, DEAD, RECOVERING)


class LatencyModel:
    """Lognormal latency body with a configurable heavy tail.

    ``sample`` draws ``exp(N(ln(median), sigma))`` seconds and, with
    probability ``tail_p``, multiplies by ``tail_mult`` — the
    occasionally-terrible-response shape real fleets exhibit and the
    hedge machinery is designed against.  Deterministic given the
    caller's seeded ``random.Random``."""

    def __init__(self, median_ms: float = 2.0, sigma: float = 0.45,
                 tail_p: float = 0.01, tail_mult: float = 25.0) -> None:
        if median_ms <= 0:
            raise ValueError(f"median_ms must be > 0, got {median_ms}")
        self.median_s = median_ms / 1000.0
        self.sigma = max(float(sigma), 0.0)
        self.tail_p = min(max(float(tail_p), 0.0), 1.0)
        self.tail_mult = max(float(tail_mult), 1.0)

    def sample(self, rng: random.Random) -> float:
        s = self.median_s * math.exp(rng.gauss(0.0, self.sigma))
        if self.tail_p > 0 and rng.random() < self.tail_p:
            s *= self.tail_mult
        return s


class FaultInjector:
    """Scriptable per-verb fault decisions — the knob surface of a
    scripted fake node, as one reusable model.

    * ``get_delay``          — every read stalls this long first (the
      straggler knob; 0 = off).
    * ``fail_puts``          — every write answers 507 (broken disk).
    * ``put_fail_status``/``put_fail_remaining`` — the next N writes
      answer with this status, then normal service resumes (the
      transient-retry script).
    * ``torn_put_bytes``/``torn_put_remaining`` — the next N writes
      are ACKED but persist only a prefix of the payload: the silent
      torn write the crash harness (``sim/crash.py``) enumerates at
      syscall scale, scriptable here at fleet scale.  Only the
      content-address gate can catch it afterwards — the disk-fault
      axis of scenario scripting (``disk_corruption_storm``)."""

    def __init__(self, fail_puts: bool = False) -> None:
        self.get_delay = 0.0
        self.fail_puts = fail_puts
        self.put_fail_status = 0
        self.put_fail_remaining = 0
        self.torn_put_bytes = 0
        self.torn_put_remaining = 0

    def get_fault(self) -> float:
        """Seconds a read must stall before being served."""
        return self.get_delay

    def put_fault(self) -> int:
        """HTTP status a write must fail with (0 = serve normally).
        One-shot statuses consume their budget here."""
        if self.put_fail_remaining > 0:
            self.put_fail_remaining -= 1
            return self.put_fail_status or 503
        if self.fail_puts:
            return 507
        return 0

    def torn_fault(self, nbytes: int) -> Optional[int]:
        """Bytes the next write silently keeps (None = write whole).
        One-shot budget, like ``put_fault`` — consumed only when the
        write actually tears (a payload already shorter than the torn
        prefix cannot tear, and must not burn the budget)."""
        if self.torn_put_remaining > 0 and 0 < self.torn_put_bytes \
                < nbytes:
            self.torn_put_remaining -= 1
            return self.torn_put_bytes
        return None


class SimNode:
    """One simulated storage node; all service verbs live here.

    State reads/writes are plain attribute flips on the owning loop's
    thread (scenario scripts and service coroutines share the loop);
    the byte counters are lock-guarded because a metrics scrape may
    read them cross-thread, same as every other stats source."""

    def __init__(self, fabric: "SimFabric", node_id: str, zone: str,
                 latency: LatencyModel, bandwidth_bps: float,
                 seed: int) -> None:
        self.fabric = fabric
        self.node_id = node_id
        self.zone = zone
        self.latency = latency
        self.bandwidth_bps = float(bandwidth_bps)
        self.store: dict[str, bytes] = {}
        self.rng = random.Random(seed)
        self.state = HEALTHY
        self.state_since = _clock.monotonic()
        #: fault-shape knobs (scenario scripts tune per node)
        self.slow_factor = 10.0
        self.recover_factor = 3.0
        self.recover_s = 10.0
        self.partition_stall_s = 5.0
        self.error_status = 503
        #: scripted per-verb injection on top of the state machine
        self.faults = FaultInjector()
        self._lock = threading.Lock()
        self.ops = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.errors_injected = 0
        self.torn_writes = 0

    # ---- state machine ----

    def set_state(self, state: str) -> None:
        """Operator/scenario transition; any known state is reachable
        from any other (a crash can interrupt a recovery)."""
        if state not in STATES:
            raise ValueError(f"unknown node state {state!r} "
                             f"(know {STATES})")
        prev = self.state
        self.state = state
        self.state_since = _clock.monotonic()
        self.fabric.trace("node_state", node=self.node_id,
                          zone=self.zone, state=state, prev=prev)

    def effective_state(self) -> str:
        """The state the next request observes — ``recovering`` lapses
        to ``healthy`` after ``recover_s`` without needing a timer."""
        if (self.state == RECOVERING
                and _clock.monotonic() - self.state_since
                >= self.recover_s):
            self.set_state(HEALTHY)
        return self.state

    # ---- service plumbing ----

    def _bump(self, **deltas: int) -> None:
        with self._lock:
            for key, delta in deltas.items():
                setattr(self, key, getattr(self, key) + delta)

    async def _serve(self, verb: str, nbytes: int) -> None:
        """The shared front half of every verb: fault gate, latency,
        virtual bandwidth.  Raises the location-level error a real
        node in this state would produce."""
        self._bump(ops=1)
        state = self.effective_state()
        target = f"{self.fabric.fabric_id}/{self.node_id}"
        if state == DEAD:
            self._bump(errors_injected=1)
            raise LocationError(
                f"sim node {target} refused connection (dead)")
        if state == PARTITIONED:
            await _clock.sleep(self.partition_stall_s)
            self._bump(errors_injected=1)
            raise LocationError(
                f"sim node {target} timed out (partitioned)")
        delay = self.latency.sample(self.rng)
        if state == SLOW:
            delay *= self.slow_factor
        elif state == RECOVERING:
            delay *= self.recover_factor
        if verb == "get":
            delay += self.faults.get_fault()
        if self.bandwidth_bps > 0 and nbytes > 0:
            delay += nbytes / self.bandwidth_bps
        await _clock.sleep(delay)
        if state == ERRORING:
            self._bump(errors_injected=1)
            raise HttpStatusError(self.error_status, target)
        if verb == "put":
            status = self.faults.put_fault()
            if status:
                self._bump(errors_injected=1)
                raise HttpStatusError(status, target)

    # ---- the verbs (file/location.py's sim: branches call these) ----

    async def read(self, name: str, start: int = 0,
                   length: Optional[int] = None) -> bytes:
        data = self.store.get(name)
        nbytes = 0 if data is None else \
            len(data[start: None if length is None else start + length])
        await self._serve("get", nbytes)
        if data is None:
            raise LocationError(
                f"no chunk {name!r} on sim node {self.node_id}")
        if start < 0 or (length is not None and length < 0):
            raise LocationError(f"negative range on sim chunk {name!r}")
        out = data[start: None if length is None else start + length]
        self._bump(bytes_read=len(out))
        return out

    async def write(self, name: str, data: bytes) -> None:
        await self._serve("put", len(data))
        torn = self.faults.torn_fault(len(data))
        if torn is not None:
            # silent torn write: the node ACKS the put but persists
            # only a prefix — detectable later solely by the
            # content-address gate (scrub's next pass re-reads,
            # mismatches, and repairs again)
            self.store[name] = bytes(data[:torn])
            self._bump(bytes_written=torn, torn_writes=1)
            self.fabric.trace("torn_write", node=self.node_id,
                              chunk=name, kept=torn, total=len(data))
            return
        self.store[name] = bytes(data)
        self._bump(bytes_written=len(data))

    async def delete(self, name: str) -> None:
        await self._serve("delete", 0)
        self.store.pop(name, None)

    async def exists(self, name: str) -> bool:
        await self._serve("head", 0)
        return name in self.store

    async def length(self, name: str) -> int:
        await self._serve("head", 0)
        data = self.store.get(name)
        if data is None:
            raise LocationError(
                f"no chunk {name!r} on sim node {self.node_id}")
        return len(data)

    # ---- direct (fault-free) access for scenario damage scripts ----

    def corrupt(self, name: str, offset: int, xor: int = 0x01) -> bool:
        """Flip one byte of a stored chunk in place (no latency, no
        fault gate — this is the scenario injecting damage, not a
        client doing I/O).  False when the chunk is absent."""
        data = self.store.get(name)
        if data is None or not data:
            return False
        offset %= len(data)
        raw = bytearray(data)
        raw[offset] ^= xor
        self.store[name] = bytes(raw)
        return True

    def drop(self, name: str) -> bool:
        """Remove a stored chunk outright (disk sector loss)."""
        return self.store.pop(name, None) is not None

    def stats(self) -> dict:
        with self._lock:
            return {
                "node": self.node_id,
                "zone": self.zone,
                "state": self.state,
                "chunks": len(self.store),
                "ops": self.ops,
                "bytes_read": self.bytes_read,
                "bytes_written": self.bytes_written,
                "errors_injected": self.errors_injected,
                "torn_writes": self.torn_writes,
            }


#: process-wide fabric registry — the ``slab.get_store`` analogue: the
#: registry is how a parsed ``sim:`` Location string finds its live
#: in-process node.  Re-registering an id replaces the old fabric (a
#: scenario re-run with the same id starts from a fresh node set).
_FABRICS: dict[str, "SimFabric"] = {}


def get_fabric(fabric_id: str) -> "SimFabric":
    fabric = _FABRICS.get(fabric_id)
    if fabric is None:
        raise LocationError(
            f"no live sim fabric {fabric_id!r} — sim: locations only "
            "resolve inside a simulator run")
    return fabric


def resolve(target: str) -> tuple[SimNode, str]:
    """``(node, chunk name)`` for a sim location target
    ``<fabric>/<node>/<chunk>`` (the string form the metadata plane
    round-trips)."""
    parts = target.split("/", 2)
    if len(parts) != 3 or not all(parts):
        raise LocationError(
            f"sim location {target!r} does not name "
            "<fabric>/<node>/<chunk>")
    fabric_id, node_id, name = parts
    fabric = get_fabric(fabric_id)
    node = fabric.nodes.get(node_id)
    if node is None:
        raise LocationError(
            f"no node {node_id!r} in sim fabric {fabric_id!r}")
    return node, name


class SimFabric:
    """A registered set of simulated nodes with zone topology.

    ``trace_hook`` (set by the scenario engine) receives every fabric
    event as ``(virtual_time, event, fields)`` — the seed-reproducible
    event trace.  Without a hook events are dropped (bare fabrics in
    unit tests)."""

    def __init__(self, fabric_id: str, n_nodes: int,
                 zones: tuple[str, ...] = ("az0", "az1", "az2"),
                 seed: int = 0,
                 latency: Optional[LatencyModel] = None,
                 bandwidth_bps: float = 200e6) -> None:
        if n_nodes <= 0:
            raise ValueError(f"n_nodes must be > 0, got {n_nodes}")
        if not zones:
            raise ValueError("need at least one zone")
        self.fabric_id = fabric_id
        self.seed = seed
        self.zones = tuple(zones)
        self.trace_hook: Optional[Callable[[float, str, dict], None]] \
            = None
        latency = latency or LatencyModel()
        self.nodes: dict[str, SimNode] = {}
        for i in range(n_nodes):
            node_id = f"n{i:04d}"
            zone = self.zones[i % len(self.zones)]
            # per-node rng seeded from (fabric seed, index): stable
            # across runs, independent across nodes
            self.nodes[node_id] = SimNode(
                self, node_id, zone, latency, bandwidth_bps,
                seed=(seed * 1_000_003 + i))
        _FABRICS[fabric_id] = self

    # ---- topology ----

    def nodes_in_zone(self, zone: str) -> list[SimNode]:
        return [n for n in self.nodes.values() if n.zone == zone]

    def set_zone_state(self, zone: str, state: str) -> None:
        """Zone-wide transition (the AZ-outage primitive)."""
        hit = self.nodes_in_zone(zone)
        if not hit:
            raise ValueError(f"no nodes in zone {zone!r}")
        for node in hit:
            node.set_state(state)

    def destination_objs(self) -> list[dict]:
        """Cluster-config destination entries for every node — feed
        straight into ``Cluster.from_obj``'s ``destinations`` (zone
        tags ride along, so ``zone_rules`` placement caps work)."""
        return [
            {"location": f"sim:{self.fabric_id}/{node_id}",
             "zones": [node.zone]}
            for node_id, node in self.nodes.items()
        ]

    # ---- tracing / teardown ----

    def trace(self, event: str, **fields: object) -> None:
        hook = self.trace_hook
        if hook is not None:
            hook(_clock.monotonic(), event, fields)

    def stats(self) -> dict:
        by_state: dict[str, int] = {}
        for node in self.nodes.values():
            by_state[node.state] = by_state.get(node.state, 0) + 1
        return {
            "fabric": self.fabric_id,
            "nodes": len(self.nodes),
            "zones": list(self.zones),
            "by_state": dict(sorted(by_state.items())),
            "chunks": sum(len(n.store) for n in self.nodes.values()),
            "errors_injected": sum(n.errors_injected
                                   for n in self.nodes.values()),
        }

    def close(self) -> None:
        """Unregister; parsed ``sim:`` locations stop resolving (the
        metadata outliving a run must fail loudly, not serve stale
        node dicts)."""
        if _FABRICS.get(self.fabric_id) is self:
            del _FABRICS[self.fabric_id]
