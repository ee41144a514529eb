"""The port's location-health scoreboard and what it feeds, held against the
assertions of ``tests/test_health.py``.

Unit pins of ``cluster/health.py`` (EWMA, ordering, breaker, hedge budget
and delay, thread safety), the tunables that arm it, health-aware
placement, the transient-error retries of both planes, the profiler's
failure trail and health table, and the hedged and straggler reads of
``FilePart.read_buffers``: byte-identical to hedging off, with hedges that
fire and win against a slow location.  The port serves only local paths,
so slow and flaky nodes are made by wrapping ``Location`` methods.
"""

import asyncio
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from chunky_bits_tpu_torch.cluster import tunables
from chunky_bits_tpu_torch.cluster.destination import _WriterState
from chunky_bits_tpu_torch.cluster.health import (CLOSED, HALF_OPEN, OPEN,
                                                  HealthScoreboard,
                                                  location_key)
from chunky_bits_tpu_torch.cluster.nodes import ClusterNodes
from chunky_bits_tpu_torch.cluster.profile import ClusterProfile
from chunky_bits_tpu_torch.errors import (HttpStatusError, LocationError,
                                          SerdeError, ShardError,
                                          is_transient_error)
from chunky_bits_tpu_torch.file import (AnyHash, Chunk, FilePart, Location,
                                        LocationContext, new_profiler)
from chunky_bits_tpu_torch.obs.metrics import get_registry
from tests.test_torch_file import run


class Clock:
    """A deterministic monotonic clock to inject."""

    def __init__(self) -> None:
        self.now = 1000.0

    def __call__(self) -> float:
        return self.now


def node(name: str) -> Location:
    """A chunk location on storage node ``name`` (its parent directory)."""
    return Location.local(f"/{name}/sha256-aa")


@pytest.fixture(autouse=True)
def port_knobs(monkeypatch):
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    for knob in ("HEDGE_MS", "READ_RETRIES", "STAGGER_SECONDS"):
        monkeypatch.delenv("CHUNKY_BITS_TORCH_" + knob, raising=False)


# ---- identity, EWMA, ordering ----

def test_location_key_groups_by_node():
    http = [SimpleNamespace(kind="http", target=url) for url in (
        "http://10.0.0.1:8080/chunks/sha256-aa",
        "http://10.0.0.1:8080/chunks/sha256-bb",
        "http://10.0.0.2:8080/chunks/sha256-aa")]
    assert location_key(http[0]) == location_key(http[1]) \
        == ("http", "10.0.0.1:8080")
    assert location_key(http[0]) != location_key(http[2])
    d1, d2, d3 = (Location.parse(p) for p in (
        "/disk0/sha256-aa", "/disk0/sha256-bb", "/disk1/sha256-aa"))
    assert location_key(d1) == location_key(d2) == ("local", "/disk0")
    assert location_key(d1) != location_key(d3)


def test_ewma_latency_and_order():
    sb = HealthScoreboard()
    fast, slow = node("fast"), node("slow")
    for _ in range(10):
        sb.record(fast, True, 0.002)
        sb.record(slow, True, 0.200)
    assert sb.order([slow, fast]) == [fast, slow]
    rows = {r.key[1]: r for r in sb.stats().locations}
    assert rows["/fast"].ewma_ms == pytest.approx(2.0, rel=0.2)
    assert rows["/slow"].ewma_ms == pytest.approx(200.0, rel=0.3)


@pytest.mark.parametrize("case", ["unknown", "errors", "open_breaker"])
def test_order(case):
    """A fresh scoreboard keeps metadata order exactly (the hedging-off
    walk is the reference's); a failing node ranks last, an open breaker
    too, but it is never dropped."""
    sb = HealthScoreboard(clock=Clock())
    if case == "unknown":
        locs = [node(f"n{i}") for i in range(6)]
        assert sb.order(locs) == locs
        return
    bad, ok = node("bad"), node("ok")
    sb.record(ok, True, 0.01)
    for _ in range(3 if case == "errors" else sb.BREAKER_FAILURES):
        sb.record(bad, False, 0.01)
    assert sb.order([bad, ok]) == [ok, bad]


def test_breaker_closed_open_halfopen_cycle():
    clock = Clock()
    sb = HealthScoreboard(clock=clock)
    flaky = node("flaky")
    assert sb.breaker_state(flaky) == CLOSED
    for _ in range(sb.BREAKER_FAILURES - 1):
        sb.record(flaky, False)
    assert sb.breaker_state(flaky) == CLOSED  # one short of the trip
    sb.record(flaky, False)
    assert sb.breaker_state(flaky) == OPEN and sb.degraded(flaky)
    clock.now += sb.BREAKER_COOLDOWN + 0.1
    assert sb.breaker_state(flaky) == HALF_OPEN
    sb.record(flaky, False)  # a failed probe re-opens at once
    assert sb.breaker_state(flaky) == OPEN
    clock.now += sb.BREAKER_COOLDOWN + 0.1
    assert sb.breaker_state(flaky) == HALF_OPEN
    sb.record(flaky, True, 0.01)
    assert sb.breaker_state(flaky) == CLOSED
    # closed, but its error rate still marks it degraded for placement
    assert sb.degraded(flaky)
    assert sb.degraded_keys() == frozenset({location_key(flaky)})


# ---- hedge budget and delay ----

def test_hedge_budget_exhaustion_and_accrual():
    sb = HealthScoreboard(hedge_ms=10.0)
    assert sb.hedge_enabled and not HealthScoreboard().hedge_enabled
    burst = int(sb.hedge_burst)
    for _ in range(burst):
        assert sb.try_fire_hedge()
    assert not sb.try_fire_hedge(), "budget should be exhausted"
    assert sb.hedges_fired == burst
    for _ in range(int(1 / sb.hedge_ratio) - 1):
        sb.note_primary()
        assert not sb.try_fire_hedge()
    sb.note_primary()
    assert sb.try_fire_hedge()
    # a gate that denies costs no token
    sb.set_hedge_gate(lambda: False)
    assert not sb.hedge_allowed() and not sb.try_fire_hedge()


@pytest.mark.parametrize("samples,want", [
    ((), 0.010), ((0.0001,) * 50, 0.010), ((5.0,) * 200, 0.200),
    ((0.050,) * 100, 0.050)])
def test_hedge_delay_clamps_to_floor_and_ceiling(samples, want):
    sb = HealthScoreboard(hedge_ms=10.0)
    for seconds in samples:
        sb.record(node("a"), True, seconds)
    assert sb.hedge_delay() == pytest.approx(want, rel=0.05)


def test_latency_floor_learns_without_verdict():
    """A cancelled hedge loser's lower bound moves the EWMA but is no
    verdict: it does not close an open breaker."""
    sb = HealthScoreboard(clock=Clock())
    slow, fast = node("slow"), node("fast")
    sb.record(fast, True, 0.002)
    sb.record_latency_floor(slow, 0.050)
    assert sb.order([slow, fast]) == [fast, slow]
    row = {r.key[1]: r for r in sb.stats().locations}["/slow"]
    assert row.err_rate == pytest.approx(0.0)
    for _ in range(sb.BREAKER_FAILURES):
        sb.record(slow, False)
    sb.record_latency_floor(slow, 0.100)
    assert sb.breaker_state(slow) == OPEN


def test_inflight_pairing_and_cancel_verdict():
    sb = HealthScoreboard()
    n = node("n")
    sb.begin(n)
    sb.begin(n)
    assert sb.stats().locations[0].inflight == 2
    sb.finish(n, True, 0.01)
    sb.finish(n, None, None)  # a cancelled racer: no sample
    row = sb.stats().locations[0]
    assert (row.inflight, row.completions) == (0, 1)
    assert row.err_rate == pytest.approx(0.0)
    assert row.to_obj()["node"] == "/n" and "n=1" in str(row)


def test_scoreboard_is_thread_safe():
    sb = HealthScoreboard(hedge_ms=5.0)
    n = node("n")

    def work():
        for i in range(500):
            sb.begin(n)
            sb.finish(n, i % 10 != 0, 0.001)
            sb.note_primary()

    threads = [threading.Thread(target=work) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    row = sb.stats().locations[0]
    assert (row.completions, row.inflight) == (2000, 0)
    assert sb.stats().primaries == 2000


def test_scoreboard_registers_with_the_metrics_registry():
    sb = HealthScoreboard()
    assert any(src is sb for src in get_registry().sources("health"))


# ---- errors and tunables ----

def test_transient_error_classification():
    assert is_transient_error(HttpStatusError(503, "http://n/x"))
    assert is_transient_error(HttpStatusError(429, "http://n/x"))
    assert not is_transient_error(HttpStatusError(404, "http://n/x"))
    assert not is_transient_error(HttpStatusError(507, "http://n/x"))
    assert not is_transient_error(LocationError("connection refused"))
    err = ShardError("write failed")
    err.__cause__ = HttpStatusError(500, "http://n/x")
    assert is_transient_error(err)


def test_tunables_hedge_and_retry_serde():
    t = tunables.Tunables.from_obj({"hedge_ms": 15, "read_retries": 2})
    assert (t.hedge_ms, t.read_retries) == (15.0, 2)
    obj = t.to_obj()
    assert (obj["hedge_ms"], obj["read_retries"]) == (15.0, 2)
    t2 = tunables.Tunables.from_obj(obj)
    assert (t2.hedge_ms, t2.read_retries) == (15.0, 2)
    t3 = tunables.Tunables.from_obj({})
    assert (t3.hedge_ms, t3.read_retries) == (0.0, 1)
    assert "hedge_ms" not in t3.to_obj() and "read_retries" not in \
        t3.to_obj()
    assert t.location_context().read_retries == 2
    for bad in ({"hedge_ms": -1}, {"read_retries": "many"}):
        with pytest.raises(SerdeError):
            tunables.Tunables.from_obj(bad)


def test_tunables_env_defaults(monkeypatch):
    monkeypatch.setenv("CHUNKY_BITS_TORCH_HEDGE_MS", "12.5")
    monkeypatch.setenv("CHUNKY_BITS_TORCH_READ_RETRIES", "3")
    # the JAX package's variables do not reconfigure the port
    monkeypatch.setenv("CHUNKY_BITS_TPU_HEDGE_MS", "99")
    t = tunables.Tunables.from_obj({})
    assert (t.hedge_ms, t.read_retries) == (12.5, 3)
    t2 = tunables.Tunables.from_obj({"hedge_ms": 0, "read_retries": 0})
    assert (t2.hedge_ms, t2.read_retries) == (0.0, 0)
    monkeypatch.setenv("CHUNKY_BITS_TORCH_HEDGE_MS", "fast")
    monkeypatch.setenv("CHUNKY_BITS_TORCH_READ_RETRIES", "-2")
    assert (tunables.hedge_ms(), tunables.read_retries()) == (0.0, 1)
    monkeypatch.setenv("CHUNKY_BITS_TORCH_STAGGER_SECONDS", "0.02")
    assert tunables.stagger_seconds() == 0.02
    monkeypatch.setenv("CHUNKY_BITS_TORCH_STAGGER_SECONDS", "soon")
    assert tunables.stagger_seconds() == 0.1
    monkeypatch.setenv("CHUNKY_BITS_TORCH_STAGGER_SECONDS", "")
    assert tunables.env_seconds("CHUNKY_BITS_TORCH_STAGGER_SECONDS",
                                default=2.0) == 2.0


# ---- placement ----

def test_next_writer_deprioritizes_open_breaker(tmp_path):
    """With node 0's breaker open, placement prefers the healthy nodes
    before node 0 fails a write, and keeps it as the last resort; with no
    health data the draw is the reference's."""
    dirs = []
    for i in range(4):
        (tmp_path / f"disk{i}").mkdir()
        dirs.append(str(tmp_path / f"disk{i}"))
    nodes = ClusterNodes.from_obj([{"location": x} for x in dirs])
    profile = ClusterProfile.from_obj({"data": 1, "parity": 0})
    hash_ = AnyHash.from_buf(b"seed")

    async def draws(health, n):
        cx = LocationContext()
        cx.health = health
        state = _WriterState(nodes, profile, cx)
        return [(await state.next_writer(hash_))[0] for _ in range(n)]

    assert set(run(draws(None, 4))) == {0, 1, 2, 3}
    sb = HealthScoreboard()
    for _ in range(sb.BREAKER_FAILURES):
        sb.record(Location.local(dirs[0] + "/chunk"), False)
    picked = run(draws(sb, 4))
    assert 0 not in picked[:3] and picked[3] == 0


# ---- transient retries on both planes ----

def flaky(monkeypatch, method, fails: int):
    """Make ``Location.<method>`` raise a transient 503 on its first
    ``fails`` calls; returns the list of calls."""
    calls = []
    real = getattr(Location, method)

    async def wrapped(self, *args, **kwargs):
        calls.append(str(self))
        if len(calls) <= fails:
            err = HttpStatusError(503, str(self))
            if method == "write_subfile":
                raise ShardError("503") from err
            raise err
        return await real(self, *args, **kwargs)

    monkeypatch.setattr(Location, method, wrapped)
    return calls


@pytest.mark.parametrize("retries,fails,ok", [(1, 1, True), (0, 1, False),
                                              (2, 2, True)])
def test_shard_write_retries_transient_errors(tmp_path, monkeypatch,
                                              retries, fails, ok):
    """A transient failure is retried ``read_retries`` times against the
    same node before the node is invalidated."""
    from chunky_bits_tpu_torch.cluster.destination import Destination

    (tmp_path / "d").mkdir()
    nodes = ClusterNodes.from_obj([{"location": str(tmp_path / "d")}])
    profile = ClusterProfile.from_obj({"data": 1, "parity": 0})
    calls = flaky(monkeypatch, "write_subfile", fails)
    dest = Destination(nodes, profile, LocationContext(read_retries=retries))
    writer = dest.get_writers(1)[0]
    write = writer.write_shard(AnyHash.from_buf(b"x"), b"x")
    if ok:
        locs = run(write)
        assert len(calls) == fails + 1 and len(locs) == 1
    else:
        with pytest.raises(ShardError):
            run(write)


@pytest.mark.parametrize("retries,ok", [(1, True), (0, False)])
def test_read_retries_transient_errors(tmp_path, monkeypatch, retries, ok):
    payload = bytes(range(256)) * 16
    (tmp_path / "c").write_bytes(payload)
    chunk = Chunk(hash=AnyHash.from_buf(payload),
                  locations=[Location.local(str(tmp_path / "c"))])
    part = FilePart(chunksize=len(payload), data=[chunk], parity=[])
    monkeypatch.setattr(Location, "read_view_mapper", lambda self, cx=None:
                        None)
    calls = flaky(monkeypatch, "read", 1)
    profiler, reporter = new_profiler()
    read = part.read(LocationContext(profiler=profiler,
                                     read_retries=retries))
    if ok:
        assert run(read) == payload and len(calls) == 2
    else:
        with pytest.raises(Exception, match="readable"):
            run(read)
        assert "503" in str(reporter.profile())


# ---- the read path's failure trail and health feed ----

def replicated_part(tmp_path, payloads, bad=None):
    """A part of ``payloads`` with each chunk on two nodes, r0 and r1;
    ``bad`` = "missing" or "corrupt" spoils every chunk's r0 copy."""
    chunks = []
    for ci, payload in enumerate(payloads):
        locations = []
        for rep in range(2):
            f = tmp_path / f"r{rep}" / f"c{ci}"
            f.parent.mkdir(parents=True, exist_ok=True)
            if rep == 0 and bad == "corrupt":
                f.write_bytes(bytes(len(payload)))
            elif not (rep == 0 and bad == "missing"):
                f.write_bytes(payload)
            locations.append(Location.local(str(f)))
        chunks.append(Chunk(hash=AnyHash.from_buf(payload),
                            locations=locations))
    return FilePart(chunksize=len(payloads[0]), data=chunks, parity=[])


@pytest.mark.parametrize("bad", ["missing", "corrupt"])
def test_failed_locations_are_reported_and_demerited(tmp_path, bad):
    rng = np.random.default_rng(9)
    payloads = [rng.integers(0, 256, 2048, dtype=np.uint8).tobytes()
                for _ in range(2)]
    part = replicated_part(tmp_path, payloads, bad)
    profiler, reporter = new_profiler()
    cx = LocationContext(profiler=profiler)
    cx.health = HealthScoreboard()
    assert run(part.read(cx)) == b"".join(payloads)
    report = reporter.profile()
    assert len(report.location_failures) == 2
    assert all("/r0/" in str(loc) for loc, _why in report.location_failures)
    if bad == "corrupt":
        assert all("hash mismatch" in why
                   for _loc, why in report.location_failures)
    assert "ReadFailures<" in str(report) and "Health<" in str(report)
    rows = {r.key[1]: r for r in cx.health.stats().locations}
    assert rows[str(tmp_path / "r0")].errors >= 1
    assert rows[str(tmp_path / "r1")].errors == 0


# ---- hedged and straggler reads ----

def test_hedged_read_byte_identity_fuzz(tmp_path):
    """Every chunk on two live nodes and hedges firing on almost every
    fetch: the bytes equal hedging off, whichever copy wins."""
    rng = np.random.default_rng(21)
    for trial in range(6):
        d = int(rng.integers(2, 5))
        size = int(rng.integers(100, 5000))
        payloads = [rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                    for _ in range(d)]
        part = replicated_part(tmp_path / f"t{trial}", payloads)
        cx = LocationContext()
        cx.health = HealthScoreboard(hedge_ms=0.001)
        assert run(part.read(cx)) == b"".join(payloads), trial


def slow_node(monkeypatch, prefix: str, seconds: float):
    """Every read under ``prefix`` takes ``seconds`` longer (and skips the
    page-cache fast path, so it goes through ``Location.read``)."""
    real_read = Location.read
    real_mapper = Location.read_view_mapper

    async def read(self, cx=None):
        if self.target.startswith(prefix):
            await asyncio.sleep(seconds)
        return await real_read(self, cx)

    def mapper(self, cx=None):
        if self.target.startswith(prefix):
            return None
        return real_mapper(self, cx)

    monkeypatch.setattr(Location, "read", read)
    monkeypatch.setattr(Location, "read_view_mapper", mapper)


def test_hedge_beats_a_slow_location(tmp_path, monkeypatch):
    """r0 (first in metadata order) is slow: the hedge to r1 wins, the
    loser is cancelled, and the scoreboard learns to try r1 first."""
    payloads = [bytes([i]) * 4096 for i in range(3)]
    part = replicated_part(tmp_path, payloads)
    slow_node(monkeypatch, str(tmp_path / "r0"), 0.5)
    cx = LocationContext()
    cx.health = HealthScoreboard(hedge_ms=5.0)
    assert run(part.read(cx)) == b"".join(payloads)
    stats = cx.health.stats()
    assert stats.hedges_fired >= 1 and stats.hedges_won >= 1
    first = [loc for loc in cx.health.order(part.data[0].locations)][0]
    assert "/r1/" in str(first)


def test_straggler_race_reconstructs_around_a_slow_chunk(tmp_path,
                                                         monkeypatch):
    """A data chunk whose only node is slow, and drawn first: the race
    draws a parity chunk and reconstructs instead of waiting
    (byte-identical)."""
    import random
    from chunky_bits_tpu_torch.file import FileWriteBuilder
    from chunky_bits_tpu_torch.file.collection_destination import \
        LocationsDestination
    from chunky_bits_tpu_torch.utils import aio

    dirs = []
    for i in range(5):
        (tmp_path / f"d{i}").mkdir()
        dirs.append(str(tmp_path / f"d{i}"))
    payload = np.random.default_rng(3).integers(
        0, 256, 3 * 4096, dtype=np.uint8).tobytes()
    ref = run(FileWriteBuilder().with_backend("torch")
              .with_destination(LocationsDestination(dirs))
              .with_chunk_size(4096).with_data_chunks(3)
              .with_parity_chunks(2).write(aio.BytesReader(payload)))
    part = ref.parts[0]
    slow = part.data[0].locations[0].target
    slow_node(monkeypatch, slow, 1.0)
    # the d workers draw the pool in order: data chunk 0 first
    monkeypatch.setattr(random, "randrange", lambda n: 0)
    cx = LocationContext()
    cx.health = HealthScoreboard(hedge_ms=5.0)
    assert run(part.read(cx, backend="torch"))[:len(payload)] == payload
    assert cx.health.stats().hedges_fired >= 1
