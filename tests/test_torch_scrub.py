"""The port's scrub daemon (``chunky_bits_tpu_torch/cluster/scrub.py``), held
against ``tests/test_scrub.py`` and against the JAX package's daemon.

The assertions of ``tests/test_scrub.py`` run on the ``torch`` backend over
``slab:`` and ``path`` destinations.  Time is a fake clock installed on the
clock seam (``utils/clock.py``): the token bucket's waits advance it
instead of sleeping, so the rate-bound checks read exact seconds and no
test sleeps for real.  One cluster, damaged the same way in two copies,
is scrubbed once by each package with a profiler attached (the JAX
package's fused native hash is off then, as the port has none): the
scrub and repair stats are equal, plans by kind and code, helper, written
and verified bytes.  A slab and meta-log cluster written by either
package scrubs, repairs and reads back through the other.  The
``cb_scrub_*`` and ``cb_repair_*`` families render as the JAX package
renders them.  The gateway's ``/scrub/status`` is in
``test_torch_gateway.py`` and ``scrub --once`` in ``test_torch_cli.py``.
"""

import asyncio
import os
import shutil

import pytest

from chunky_bits_tpu_torch.cluster import Cluster
from chunky_bits_tpu_torch.cluster.scrub import (ScrubDaemon, ScrubStats,
                                                 TokenBucket, maybe_build)
from chunky_bits_tpu_torch.cluster.tunables import (SCRUB_BYTES_PER_SEC_ENV,
                                                    Tunables)
from chunky_bits_tpu_torch.file.location import Location
from chunky_bits_tpu_torch.file.profiler import new_profiler
from chunky_bits_tpu_torch.obs import metrics as obs_metrics
from chunky_bits_tpu_torch.utils import aio
from chunky_bits_tpu_torch.utils import clock as clock_seam
from tests.test_torch_file import run
from tests.test_torch_slab import (flip_byte, make_cluster_obj, payload_of,
                                   read_back, write_payload)


class FakeClock(clock_seam.Clock):
    """A clock whose sleeps advance it at once (and yield to the loop)."""

    def __init__(self) -> None:
        self.now = 1000.0

    def monotonic(self) -> float:
        return self.now

    async def sleep(self, seconds: float) -> None:
        self.now += max(float(seconds), 0.0)
        await asyncio.sleep(0)


@pytest.fixture
def fake_clock():
    clock = FakeClock()
    prev = clock_seam.install(clock)
    try:
        yield clock
    finally:
        clock_seam.install(prev)


@pytest.fixture(autouse=True)
def torch_default(monkeypatch, fake_clock):
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    for knob in ("CODE", "METADATA_KIND", "REPAIR_BLOCK_BYTES",
                 "SCRUB_BYTES_PER_SEC", "CACHE_BYTES", "HEDGE_MS"):
        monkeypatch.delenv("CHUNKY_BITS_TORCH_" + knob, raising=False)


async def verify_valid(cluster, name) -> bool:
    ref = await cluster.get_file_ref(name)
    report = await ref.verify(cluster.tunables.location_context())
    return str(report.integrity()) == "Valid"


# ---- the token bucket, on the clock seam ----

def test_token_bucket_honors_rate(fake_clock):
    bucket = TokenBucket(rate=40_000)

    async def main():
        t0 = fake_clock.now
        for _ in range(6):
            await bucket.take(10_000)
        return fake_clock.now - t0

    # 60 KB against 40 KB/s with a 40 KB burst: (60-40)/40 = 0.5 s
    assert 0.5 <= run(main()) < 0.5 + TokenBucket.MAX_SLEEP


def test_token_bucket_zero_rate_and_pressure(fake_clock):
    async def main():
        free = TokenBucket(rate=0)
        for _ in range(100):
            await free.take(1 << 20)
        assert fake_clock.now == 1000.0
        squeezed = TokenBucket(rate=1000)
        squeezed.set_pressure(lambda: 1.0)  # accrual floor: 5%
        t0 = fake_clock.now
        await squeezed.take(2000)  # 1 s of burst, then 1000 B at 50 B/s
        assert 20.0 <= fake_clock.now - t0 < 20.0 + TokenBucket.MAX_SLEEP
        squeezed.set_pressure(None)
        t0 = fake_clock.now
        await squeezed.take(1000)
        assert fake_clock.now - t0 <= 1.0 + 1e-9

    run(main())


# ---- off by default; the tunable ----

def test_daemon_off_by_default(tmp_path):
    cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
    assert cluster.tunables.scrub_bytes_per_sec == 0
    assert maybe_build(cluster) is None


def test_tunable_serde_and_env_default(tmp_path, monkeypatch):
    t = Tunables.from_obj({"scrub_bytes_per_sec": 1048576})
    assert t.scrub_bytes_per_sec == 1048576
    assert t.to_obj()["scrub_bytes_per_sec"] == 1048576
    assert "scrub_bytes_per_sec" not in Tunables.from_obj(None).to_obj()
    with pytest.raises(Exception):
        Tunables.from_obj({"scrub_bytes_per_sec": -5})
    monkeypatch.setenv(SCRUB_BYTES_PER_SEC_ENV, "2048")
    assert Tunables.from_obj(None).scrub_bytes_per_sec == 2048
    monkeypatch.setenv(SCRUB_BYTES_PER_SEC_ENV, "garbage")
    assert Tunables.from_obj(None).scrub_bytes_per_sec == 0
    monkeypatch.setenv("CHUNKY_BITS_TPU_SCRUB_BYTES_PER_SEC", "99")
    assert Tunables.from_obj(None).scrub_bytes_per_sec == 0
    assert Tunables.from_obj(
        {"scrub_bytes_per_sec": 7}).scrub_bytes_per_sec == 7
    cluster = Cluster.from_obj(make_cluster_obj(
        tmp_path, tunables={"scrub_bytes_per_sec": 4096}))
    daemon = maybe_build(cluster)
    assert daemon is not None and daemon.rate == 4096


# ---- detection, demerit, repair ----

def test_scrub_detects_demerits_and_repairs(tmp_path):
    cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
    payload = write_payload(cluster, "a/obj", 30000, seed=1)
    write_payload(cluster, "b", 9000, seed=2)

    async def main():
        ref = await cluster.get_file_ref("a/obj")
        flip_byte(ref.parts[0].data[0].locations[0], 11, 1)
        daemon = ScrubDaemon(cluster, bytes_per_sec=10_000_000)
        stats = await daemon.run_once()
        assert stats.files_scanned == 2 and stats.passes == 1
        assert stats.corrupt == 1 and stats.repaired == 1
        assert stats.bytes_verified > 0
        health = cluster.health_scoreboard().stats()
        assert any(row.errors >= 1 for row in health.locations), health
        assert await verify_valid(cluster, "a/obj")
        assert await read_back(cluster, "a/obj") == payload
        profiler, reporter = new_profiler()
        profiler.attach_scrub(daemon)
        assert "Scrub<scanned=2f/" in str(reporter.profile())
        assert isinstance(profiler.scrub_stats()[0], ScrubStats)

    run(main())


def test_scrub_repairs_missing_extent(tmp_path):
    cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
    payload = write_payload(cluster, "obj", 24000, seed=3)

    async def main():
        ref = await cluster.get_file_ref("obj")
        await ref.parts[0].parity[0].locations[0].delete()
        stats = await ScrubDaemon(cluster, bytes_per_sec=0).run_once()
        assert stats.unavailable == 1 and stats.repaired == 1
        assert await verify_valid(cluster, "obj")
        assert await read_back(cluster, "obj") == payload

    run(main())


def test_scrub_no_repair_mode_reports_only(tmp_path):
    cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
    write_payload(cluster, "obj", 15000, seed=4)

    async def main():
        ref = await cluster.get_file_ref("obj")
        flip_byte(ref.parts[0].data[0].locations[0], 11, 1)
        daemon = ScrubDaemon(cluster, bytes_per_sec=0, repair=False)
        stats = await daemon.run_once()
        assert stats.corrupt == 1 and stats.repaired == 0
        stats = await daemon.run_once()
        assert stats.corrupt == 2

    run(main())


def test_scrub_rate_bound_measured(tmp_path, fake_clock):
    """~45 KB of replicas against a 30 KB/s budget (30 KB burst): one pass
    takes at least (bytes - burst) / rate on the clock seam."""
    cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
    write_payload(cluster, "obj", 27000, seed=5)

    async def main():
        daemon = ScrubDaemon(cluster, bytes_per_sec=30_000)
        t0 = fake_clock.now
        stats = await daemon.run_once()
        elapsed = fake_clock.now - t0
        floor = (stats.bytes_verified - 30_000) / 30_000
        assert floor > 0.1, stats.bytes_verified
        assert floor <= elapsed < floor + 2 * TokenBucket.MAX_SLEEP
        assert stats.last_pass_seconds == elapsed

    run(main())


def test_scrub_prioritizes_degraded_nodes_first(tmp_path):
    cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
    write_payload(cluster, "healthy", 12000, seed=6)
    write_payload(cluster, "atrisk", 12000, seed=7)

    async def main():
        ref = await cluster.get_file_ref("atrisk")
        victim = ref.parts[0].data[0].locations[0]
        health = cluster.health_scoreboard()
        for _ in range(6):
            health.record(victim, False)
        assert health.degraded(victim)
        daemon = ScrubDaemon(cluster, bytes_per_sec=0)
        order = []
        original = daemon._scrub_ref

        async def spy(path, ref, cx, pipe, snapshot):
            order.append(path)
            return await original(path, ref, cx, pipe, snapshot)

        daemon._scrub_ref = spy
        await daemon.run_once()
        assert order == ["atrisk", "healthy"], order

    run(main())


@pytest.mark.parametrize("planner", [True, False])
def test_scrub_rewrites_corrupt_replica_beside_healthy_one(tmp_path,
                                                           planner):
    """A corrupt replica with a healthy sibling is overwritten in place,
    so the next pass finds nothing (the planner's copy plan, or the
    legacy whole-replica rewrite)."""
    cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
    payload = write_payload(cluster, "obj", 21000, seed=30)

    async def main():
        ref = await cluster.get_file_ref("obj")
        chunk = ref.parts[0].data[0]
        data = await chunk.locations[0].read()
        victim_root = os.path.dirname(chunk.locations[0].target)
        other = next(d for d in (os.path.join(str(tmp_path), f"disk{i}")
                                 for i in range(5)) if d != victim_root)
        replica = Location.parse(f"slab:{other}/{chunk.hash}")
        await replica.write(bytes(data))
        chunk.locations.append(replica)
        await cluster.write_file_ref("obj", ref)
        flip_byte(chunk.locations[0], 11, 1)
        daemon = ScrubDaemon(cluster, bytes_per_sec=0, planner=planner)
        stats1 = await daemon.run_once()
        assert stats1.corrupt == 1 and stats1.repaired == 1
        stats2 = await daemon.run_once()
        assert stats2.corrupt == stats1.corrupt
        assert await verify_valid(cluster, "obj")
        assert await read_back(cluster, "obj") == payload

    run(main())


def test_scrub_repair_never_clobbers_concurrent_overwrite(tmp_path):
    """The republish fence: a client overwrite that lands while the pass
    holds the old reference wins (the legacy shape republishes; the
    overwrite lands inside the pass's first metered read)."""
    cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
    write_payload(cluster, "obj", 27000, seed=20)
    new_payload = payload_of(5000, 21)

    async def main():
        ref = await cluster.get_file_ref("obj")
        for part in ref.parts:
            await part.data[0].locations[0].delete()
        daemon = ScrubDaemon(cluster, bytes_per_sec=0, planner=False)
        take = daemon._bucket.take
        fired = []

        async def overwrite_once(nbytes):
            if not fired:
                fired.append(True)
                await cluster.write_file(
                    "obj", aio.BytesReader(new_payload),
                    cluster.get_profile())
            await take(nbytes)

        daemon._bucket.take = overwrite_once
        stats = await daemon.run_once()
        assert fired and stats.unavailable >= 1
        assert await read_back(cluster, "obj") == new_payload

    run(main())


# ---- daemon lifetime ----

def test_daemon_survives_a_failing_pass_and_stops(tmp_path, fake_clock):
    cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
    write_payload(cluster, "obj", 9000, seed=31)

    async def main():
        daemon = ScrubDaemon(cluster, bytes_per_sec=10_000_000,
                             interval_seconds=5.0)
        real_run_once = daemon.run_once
        calls = {"n": 0}

        async def flaky():
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected pass failure")
            return await real_run_once()

        daemon.run_once = flaky
        daemon.start()
        assert daemon.stats().running
        daemon.start()  # idempotent while running
        for _ in range(1000):  # bounded: 10 s of real time at most
            if daemon.stats().passes >= 2:
                break
            await asyncio.sleep(0.01)
        assert daemon.stats().passes >= 2 and calls["n"] >= 3
        assert fake_clock.now >= 1000.0 + 2 * 5.0  # the interval sleeps
        await daemon.stop()
        assert not daemon.stats().running
        await daemon.stop()  # idempotent when stopped
        passes = daemon.stats().passes
        await asyncio.sleep(0.05)
        assert daemon.stats().passes == passes

    run(main())


# ---- metrics ----

def test_scrub_and_repair_families_render_as_the_jax_package(tmp_path):
    """The same counters through both packages' registries: the
    ``cb_scrub_*`` and ``cb_repair_*`` lines are equal, and the port's
    exposition parses with its own grammar checker."""
    from chunky_bits_tpu.cluster.repair import RepairPlanner as JaxPlanner
    from chunky_bits_tpu.cluster.scrub import ScrubDaemon as JaxDaemon
    from chunky_bits_tpu.obs import metrics as jax_metrics
    from chunky_bits_tpu_torch.cluster.repair import RepairPlanner

    def lines(text):
        return sorted(line for line in text.splitlines()
                      if "cb_scrub_" in line or "cb_repair_" in line)

    class Shell:
        tunables = Tunables.from_obj({"scrub_bytes_per_sec": 500})

        @staticmethod
        def health_scoreboard():
            return None

    ours_reg = obs_metrics.MetricsRegistry()
    theirs_reg = jax_metrics.MetricsRegistry()
    prev = obs_metrics.swap_registry(ours_reg)
    jprev = jax_metrics.swap_registry(theirs_reg)
    try:
        ours = ScrubDaemon(Shell, planner=False)
        theirs = JaxDaemon(Shell, planner=False)
        planners = (RepairPlanner(), JaxPlanner())
        for d in (ours, theirs):
            d._bump(files=3, chunks=15, bytes=123456, corrupt=2,
                    unavailable=1, repaired=3, repair_failures=1)
        for pl in planners:
            pl._bump("rs", plans_decode=2, helper_bytes_decode=24576,
                     bytes_rebuilt=8192, bytes_written=32768,
                     ranges_rebuilt=2)
            pl._bump("pm-msr", plans_msr=1, helper_bytes_msr=16384)
        ours_text = obs_metrics.render_exposition(ours_reg.snapshot())
        theirs_text = jax_metrics.render_exposition(theirs_reg.snapshot())
    finally:
        obs_metrics.swap_registry(prev)
        jax_metrics.swap_registry(jprev)
    assert lines(ours_text) == lines(theirs_text)
    parsed = obs_metrics.parse_exposition(ours_text)
    assert parsed["cb_scrub_corrupt_total"]["samples"][0][2] == 2
    plans = {tuple(sorted(labels.items())): value for _n, labels, value
             in parsed["cb_repair_plans_total"]["samples"]}
    assert plans[(("code", "rs"), ("kind", "decode"))] == 2
    assert plans[(("code", "pm-msr"), ("kind", "msr"))] == 1
    assert planners[0].stats().to_obj() == planners[1].stats().to_obj()


# ---- against the JAX package ----

def _relative_spec(d=3, p=2, code="rs", packed=True, meta="path",
                   backend="torch", n_nodes=5):
    dests = [{"location": ("slab:" if packed and i % 2 == 0 else "")
              + f"disk{i}"} for i in range(n_nodes)]
    return {
        "destinations": dests,
        "metadata": {"type": meta, "format": "yaml", "path": "meta"},
        "profiles": {"default": {"data": d, "parity": p,
                                 "chunk_size": 14, "code": code}},
        "tunables": {"backend": backend, "repair_block_bytes": 4096},
    }


def _damage(ref_objs):
    """The same damage on both copies: in object i, flip a byte in chunk
    i % (d+p) of part 0 (the first four objects), drop that chunk's file
    or extent in the fifth.  Returns nothing; works on either package's
    references (same wire format)."""
    for i, ref in enumerate(ref_objs):
        part = ref.parts[0]
        chunks = part.data + part.parity
        loc = chunks[i % len(chunks)].locations[0]
        if i < 4:
            flip_byte(loc, 1000 + 4096 * (i % 3))
        elif loc.is_slab():
            run(loc.delete())
        else:
            os.remove(loc.target)


def _scrub_both(tmp_path, monkeypatch, code, profiled, backend="torch"):
    """One cluster (3 slab + 2 path destinations, meta-log metadata, 16
    KiB chunks, 4 KiB digest blocks), damaged the same way in two copies
    and scrubbed once by each package (the JAX package on ``numpy``, the
    port on ``backend``), with a profiler attached or not.  Returns (the
    port's stats, the JAX package's, the port's cluster, the blobs); the
    working directory is the JAX copy's on return."""
    from chunky_bits_tpu.cluster import Cluster as JaxCluster
    from chunky_bits_tpu.cluster.scrub import ScrubDaemon as JaxDaemon
    from chunky_bits_tpu.file.profiler import new_profiler as jax_profiler

    a, b = tmp_path / "jax", tmp_path / "port"
    a.mkdir()
    for i in range(5):
        (a / f"disk{i}").mkdir()
    monkeypatch.chdir(a)
    writer = Cluster.from_obj(_relative_spec(code=code, meta="meta-log"))
    blobs = {f"o{i}": write_payload(writer, f"o{i}", 3 * (1 << 14) - 99 * i,
                                    seed=i) for i in range(6)}
    shutil.copytree(a, b)

    def scrub(cluster, daemon_cls, profiler):
        refs = [run(cluster.get_file_ref(f"o{i}")) for i in range(5)]
        _damage(refs)
        daemon = daemon_cls(cluster, bytes_per_sec=0,
                            profiler=profiler if profiled else None)
        stats = run(daemon.run_once()).to_obj()
        stats.pop("last_pass_seconds")
        return stats

    theirs = scrub(JaxCluster.from_obj(_relative_spec(
        code=code, meta="meta-log", backend="numpy")), JaxDaemon,
        jax_profiler()[0])
    monkeypatch.chdir(b)
    port = Cluster.from_obj(_relative_spec(code=code, meta="meta-log",
                                           backend=backend))
    ours = scrub(port, ScrubDaemon, new_profiler()[0])
    for name, data in blobs.items():
        assert run(read_back(port, name)) == data
        assert run(verify_valid(port, name))
    monkeypatch.chdir(a)
    jax = JaxCluster.from_obj(_relative_spec(code=code, meta="meta-log",
                                             backend="numpy"))
    for name, data in blobs.items():
        assert run(read_back(jax, name)) == data
    return ours, theirs, port, blobs


@pytest.mark.parametrize("code", ["rs", "pm-msr"])
def test_scrub_stats_equal_the_jax_package(tmp_path, monkeypatch, code):
    """With a profiler attached both packages verify on the generic path:
    equal scrub and repair stats, equal repaired bytes, and the verify
    read's bytes localize the damage (``bytes_localized`` 0)."""
    ours, theirs, _port, _blobs = _scrub_both(tmp_path, monkeypatch, code,
                                              profiled=True)
    assert ours == theirs
    rep = ours["repair"]
    assert ours["corrupt"] == 4 and ours["unavailable"] == 1
    assert ours["repaired"] == 5 and ours["repair_failures"] == 0
    if code == "rs":
        assert rep["plans_decode"] == 5 and rep["bytes_localized"] == 0
        # four 4 KiB blocks off d=3 helpers each, and one whole chunk
        # (object 4: 3 * 16 KiB - 4 * 99 bytes over 3 chunks) off 3
        assert rep["helper_bytes_decode"] == \
            4 * 3 * 4096 + 3 * ((3 * (1 << 14) - 4 * 99) // 3)
    else:
        assert rep["plans_msr"] == 5


@pytest.mark.parametrize("backend", ["torch", "native"])
@pytest.mark.parametrize("code", ["rs", "pm-msr"])
def test_scrub_stats_equal_the_jax_package_without_a_profiler(
        tmp_path, monkeypatch, code, backend):
    """Without a profiler both packages hash local and slab replicas in
    the native fused read+hash, so the planner re-reads each corrupt
    victim to localize its damage: every scrub and repair counter,
    ``bytes_localized`` and the bytes verified included, equals the JAX
    package's."""
    ours, theirs, _port, _blobs = _scrub_both(
        tmp_path, monkeypatch, code, profiled=False, backend=backend)
    assert ours == theirs
    rep = ours["repair"]
    assert ours["corrupt"] == 4 and ours["unavailable"] == 1
    assert ours["repaired"] == 5 and ours["repair_failures"] == 0
    if code == "rs":
        # each of the four flipped chunks of objects 0-3 re-read whole
        assert rep["bytes_localized"] == sum(
            (3 * (1 << 14) - 99 * i + 2) // 3 for i in range(4))
        assert rep["helper_bytes_decode"] == \
            4 * 3 * 4096 + 3 * ((3 * (1 << 14) - 4 * 99) // 3)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cluster_of_one_package_repaired_by_the_other(tmp_path, writer):
    """A slab + meta-log cluster written by one package (the JAX package
    on ``numpy``, the port on ``torch``) is damaged, scrubbed and repaired
    by the other, and reads back byte-identically through both."""
    from chunky_bits_tpu.cluster import Cluster as JaxCluster
    from chunky_bits_tpu.cluster.scrub import ScrubDaemon as JaxDaemon

    spec = make_cluster_obj(tmp_path, meta="meta-log",
                            tunables={"repair_block_bytes": 4096},
                            chunk_log2=14)
    ours = Cluster.from_obj(spec)
    theirs = JaxCluster.from_obj(dict(spec, tunables={
        "backend": "numpy", "repair_block_bytes": 4096}))
    first, second = (theirs, ours) if writer == "jax" else (ours, theirs)
    daemon_cls = ScrubDaemon if writer == "jax" else JaxDaemon
    blobs = {f"f{i}": payload_of(3 * (1 << 14) + 7 * i, 40 + i)
             for i in range(3)}

    async def main():
        for name, data in blobs.items():
            await first.write_file(name, aio.BytesReader(data),
                                   first.get_profile())
        refs = [await first.get_file_ref(name) for name in blobs]
        flip_byte(refs[0].parts[0].data[1].locations[0], 5000)
        await refs[1].parts[0].parity[0].locations[0].delete()
        stats = await daemon_cls(second, bytes_per_sec=0).run_once()
        assert (stats.corrupt, stats.unavailable, stats.repaired) == \
            (1, 1, 2)
        assert stats.repair["plans_decode"] == 2
        for name, data in blobs.items():
            assert await read_back(ours, name) == data
            assert await read_back(theirs, name) == data
            assert await verify_valid(ours, name)

    run(main())
