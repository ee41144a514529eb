"""The port's multi-tenant QoS plane (``chunky_bits_tpu_torch/cluster/qos.py``,
``gateway/qos.py`` and the gateway's wiring), held against the cases of
``tests/test_qos.py`` and against the JAX package.

The cases of the JAX suite run on the port as they stand there, the two
virtual-time cases under the port's ``sim.run``.  Beside them: one seeded
script of arrivals (tenant, class, byte cost, hold time, numpy ``SEED``)
runs through both packages' ``QosScheduler``s, each under its own
package's ``sim.run``, and must give the same grant order, the same shed
arrivals, the same virtual grant times and equal ``stats()``;
``QosConfig.from_obj`` and ``resolve`` agree on a seeded fuzz of tables,
keys and paths; and the same requests through a JAX gateway (``numpy``
backend) and the port's (``torch``), both with QoS on, give equal
per-tenant access-log splits, ``qos`` stanzas and ``cb_qos_*`` lines.
Gateway tests run on registries of their own (``swap_registries``), so
no ``qos="on"`` row leaks into other files' tests.
"""

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest

from chunky_bits_tpu_torch.cluster import tunables as tunables_mod
from chunky_bits_tpu_torch.cluster.health import HealthScoreboard
from chunky_bits_tpu_torch.cluster.qos import (
    MAX_TENANTS,
    OTHER,
    QosConfig,
    QosScheduler,
    QosShedError,
)
from chunky_bits_tpu_torch.cluster.scrub import TokenBucket
from chunky_bits_tpu_torch.errors import SerdeError
from chunky_bits_tpu_torch.obs import metrics as obs_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SEED = 20261017

#: seconds a test's event loop may run before the test fails
TIMEOUT = 60


def arun(coro, timeout=TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def swap_registries(*modules):
    """Give each metrics module (the port's, the JAX package's) a fresh
    process registry and event-family cache; returns the restore call."""
    saved = []
    for mod in modules:
        cached = dict(mod._EVENT_FAMILIES)
        mod._EVENT_FAMILIES.clear()
        saved.append((mod, mod.swap_registry(mod.MetricsRegistry()), cached))

    def restore():
        for mod, prev, cached in saved:
            mod.swap_registry(prev)
            mod._EVENT_FAMILIES.clear()
            mod._EVENT_FAMILIES.update(cached)

    return restore


@pytest.fixture
def fresh_registry():
    restore = swap_registries(obs_metrics)
    yield obs_metrics.get_registry()
    restore()


# ---- config + resolution ----

def test_config_parses_and_round_trips():
    obj = {
        "enabled": True,
        "tenants": {
            "gold": {"weight": 4, "keys": ["k-gold"],
                     "prefixes": ["/gold/"]},
            "bulk": {"rate_bytes_per_sec": 1e6, "prefixes": ["/bulk/"]},
        },
        "other": {"weight": 2},
    }
    config = QosConfig.from_obj(obj)
    assert config.enabled is True
    assert config.other_weight == 2.0
    assert config.tenant_names() == ("gold", "bulk", OTHER)
    assert QosConfig.from_obj(config.to_obj()) == config


def test_config_validation_is_loud():
    with pytest.raises(ValueError, match="unknown keys"):
        QosConfig.from_obj({"tenats": {}})
    with pytest.raises(ValueError, match="unknown keys"):
        QosConfig.from_obj({"tenants": {"a": {"wait": 1}}})
    with pytest.raises(ValueError, match="weight"):
        QosConfig.from_obj({"tenants": {"a": {"weight": 0}}})
    with pytest.raises(ValueError, match="rate_bytes_per_sec"):
        QosConfig.from_obj({"tenants": {"a": {"rate_bytes_per_sec": -1}}})
    with pytest.raises(ValueError, match="reserved"):
        QosConfig.from_obj({"tenants": {OTHER: {}}})
    with pytest.raises(ValueError, match="claimed by both"):
        QosConfig.from_obj({"tenants": {"a": {"keys": ["k"]},
                                        "b": {"keys": ["k"]}}})
    with pytest.raises(ValueError, match="MAX_TENANTS"):
        QosConfig.from_obj({"tenants": {
            f"t{i}": {} for i in range(MAX_TENANTS + 1)}})
    with pytest.raises(ValueError, match="enabled"):
        QosConfig.from_obj({"enabled": "yes"})


def test_resolution_key_beats_prefix_longest_prefix_wins():
    config = QosConfig.from_obj({"tenants": {
        "a": {"keys": ["key-a"], "prefixes": ["/data/"]},
        "b": {"prefixes": ["/data/hot/"]},
    }})
    assert config.resolve("key-a", "/data/hot/x") == "a"
    assert config.resolve(None, "/data/hot/x") == "b"
    assert config.resolve(None, "/data/cold/x") == "a"
    assert config.resolve(None, "/elsewhere") == OTHER
    assert config.resolve("key-unknown", "/elsewhere") == OTHER


def test_distinct_key_hammer_never_mints_tenants():
    config = QosConfig.from_obj({"tenants": {"gold": {"keys": ["k-gold"]}}})
    seen = {config.resolve(f"rotating-{i}", f"/spray/{i}")
            for i in range(10_000)}
    assert seen == {OTHER}

    async def hammer():
        sched = QosScheduler(config, read_capacity=4096, write_capacity=8)
        for i in range(10_000):
            tenant = config.resolve(f"rotating-{i}", "/x")
            await sched.acquire("read", tenant, cost=10)
            sched.release("read")
        return sched.stats()

    stats = arun(hammer())
    rows = {r.tenant for r in stats.rows}
    assert rows == {"gold", OTHER}
    assert stats.to_obj()["tenants"][OTHER]["admitted"] == 10_000
    assert len(rows) <= obs_metrics.MAX_LABEL_SETS


def fuzz_tables(rng, n: int):
    """``n`` seeded ``qos:`` mappings, valid and not: tenants with keys,
    overlapping prefixes, weights, rates, and bad values here and there."""
    words = ("/a/", "/a/b/", "/b", "/bulk/", "/gold/x", "/", "/a/b/c")
    tables = []
    for _ in range(n):
        tenants = {}
        for t in range(int(rng.integers(0, 5))):
            spec = {}
            if rng.random() < 0.5:
                spec["keys"] = [f"k{int(rng.integers(0, 6))}"
                                for _ in range(int(rng.integers(1, 3)))]
            if rng.random() < 0.7:
                spec["prefixes"] = [words[int(rng.integers(0, len(words)))]
                                    for _ in range(int(rng.integers(1, 3)))]
            if rng.random() < 0.4:
                spec["weight"] = [1, 2, 4.5, 0, "3", True][
                    int(rng.integers(0, 6))]
            if rng.random() < 0.2:
                spec["rate_bytes_per_sec"] = [0, 1e6, -1][
                    int(rng.integers(0, 3))]
            if rng.random() < 0.05:
                spec["burst"] = 1
            tenants[f"t{t}"] = spec
        obj = {"tenants": tenants}
        if rng.random() < 0.3:
            obj["other"] = {"weight": [1, 2, 0.5][int(rng.integers(0, 3))]}
        if rng.random() < 0.5:
            obj["enabled"] = [True, False, "yes"][int(rng.integers(0, 3))]
        tables.append(obj)
    return tables


def test_config_and_resolution_equal_jax_on_a_fuzz():
    from chunky_bits_tpu.cluster.qos import QosConfig as JaxConfig

    rng = np.random.default_rng(SEED)
    keys = [None, "", "k0", "k1", "k2", "k3", "k5", "zz"]
    paths = ["/a/b/c/d", "/a/x", "/b", "/bx", "/bulk/y", "/gold/xy", "/",
             "/zzz", ""]
    valid = 0
    for obj in fuzz_tables(rng, 200):
        def parse(cls):
            try:
                return "ok", cls.from_obj(obj)
            except ValueError as err:
                return "error", str(err)

        ours, theirs = parse(QosConfig), parse(JaxConfig)
        assert ours[0] == theirs[0], obj
        if ours[0] == "error":
            assert ours[1] == theirs[1], obj
            continue
        valid += 1
        assert ours[1].to_obj() == theirs[1].to_obj()
        assert ours[1].tenant_names() == theirs[1].tenant_names()
        for key in keys:
            for path in paths:
                assert ours[1].resolve(key, path) == \
                    theirs[1].resolve(key, path), (obj, key, path)
    assert valid >= 50, valid


# ---- the scheduler ----

def test_drr_interleaves_tenants_instead_of_fifo():
    async def main():
        config = QosConfig.from_obj({"tenants": {
            "ant": {"keys": ["A"]}, "vic": {"keys": ["V"]}}})
        sched = QosScheduler(config, read_capacity=2, write_capacity=1,
                             queue_timeout_s=30)
        await sched.acquire("read", "ant", cost=100)
        await sched.acquire("read", "ant", cost=100)
        grants: list = []

        async def waiter(tenant, tag):
            await sched.acquire("read", tenant, cost=100)
            grants.append(tag)

        tasks = [asyncio.ensure_future(waiter("ant", f"a{i}"))
                 for i in range(4)]
        await asyncio.sleep(0)
        tasks += [asyncio.ensure_future(waiter("vic", f"v{i}"))
                  for i in range(2)]
        await asyncio.sleep(0)
        assert sched.queued("read") == 6
        assert sched.pressure() == 1.0
        for _ in range(6):
            sched.release("read")
            await asyncio.sleep(0)
        await asyncio.gather(*tasks)
        assert grants[:4] == ["a0", "v0", "a1", "v1"], grants

    arun(main())


def test_writes_gated_while_reads_queue():
    async def main():
        sched = QosScheduler(QosConfig.from_obj({}), read_capacity=1,
                             write_capacity=4, queue_timeout_s=30)
        await sched.acquire("read", OTHER)
        read_granted = asyncio.Event()
        write_granted = asyncio.Event()

        async def reader():
            await sched.acquire("read", OTHER)
            read_granted.set()

        async def writer():
            await sched.acquire("write", OTHER)
            write_granted.set()

        r = asyncio.ensure_future(reader())
        await asyncio.sleep(0)
        w = asyncio.ensure_future(writer())
        for _ in range(3):
            await asyncio.sleep(0)
        assert not write_granted.is_set()
        sched.release("read")
        for _ in range(3):
            await asyncio.sleep(0)
        assert read_granted.is_set()
        assert write_granted.is_set()
        await asyncio.gather(r, w)

    arun(main())


def test_queue_full_and_deadline_shed():
    async def main():
        sched = QosScheduler(QosConfig.from_obj({}), read_capacity=1,
                             write_capacity=1, max_queue=1,
                             queue_timeout_s=0.05)
        await sched.acquire("read", OTHER)
        waiter = asyncio.ensure_future(sched.acquire("read", OTHER))
        await asyncio.sleep(0)
        with pytest.raises(QosShedError, match="queue full"):
            await sched.acquire("read", OTHER)
        with pytest.raises(QosShedError, match="admission wait"):
            await waiter
        stats = sched.stats().to_obj()["tenants"][OTHER]
        assert stats["shed"] == 2
        assert stats["queue_peak"] == 1

    arun(main())


def test_cancelled_waiter_holds_no_slot():
    """A waiter cancelled while queued (the client went away) leaves the
    line and holds no slot: the next release grants the waiter behind it,
    and every slot comes back."""
    async def main():
        sched = QosScheduler(QosConfig.from_obj({}), read_capacity=1,
                             write_capacity=1, queue_timeout_s=30)
        await sched.acquire("read", OTHER)
        gone = asyncio.ensure_future(sched.acquire("read", OTHER))
        behind = asyncio.ensure_future(sched.acquire("read", OTHER))
        await asyncio.sleep(0)
        assert sched.queued("read") == 2
        gone.cancel()
        await asyncio.gather(gone, return_exceptions=True)
        assert sched.queued("read") == 1
        sched.release("read")
        await asyncio.wait_for(behind, 1.0)
        sched.release("read")
        stats = sched.stats()
        assert (stats.read_in_flight, sched.queued("read")) == (0, 0)
        assert stats.to_obj()["tenants"][OTHER]["admitted"] == 2

    arun(main())


def test_idle_pipe_grants_oversized_waiter():
    from chunky_bits_tpu_torch.cluster.qos import QUANTUM

    async def main():
        sched = QosScheduler(QosConfig.from_obj({}), read_capacity=1,
                             write_capacity=1, queue_timeout_s=30.0)
        await sched.acquire("read", OTHER)
        waiter = asyncio.ensure_future(
            sched.acquire("read", OTHER, cost=10 * QUANTUM))
        await asyncio.sleep(0)
        sched.release("read")
        await asyncio.wait_for(waiter, timeout=1.0)
        stats = sched.stats().to_obj()["tenants"][OTHER]
        assert stats["admitted"] == 2
        assert stats["shed"] == 0
        sched.release("read")

    arun(main())


def test_rate_bucket_throttles_in_virtual_time():
    from chunky_bits_tpu_torch.sim import run as sim_run
    from chunky_bits_tpu_torch.utils import clock as clock_mod

    async def main():
        config = QosConfig.from_obj({"tenants": {
            "bulk": {"rate_bytes_per_sec": 1000.0, "keys": ["B"]}}})
        sched = QosScheduler(config, read_capacity=64, write_capacity=8)
        t0 = clock_mod.monotonic()
        for _ in range(5):
            await sched.acquire("read", "bulk", cost=1000)
            sched.release("read")
        elapsed = clock_mod.monotonic() - t0
        return elapsed, sched.stats().to_obj()["tenants"]["bulk"]

    elapsed, row = sim_run(main())
    assert elapsed >= 3.5, elapsed
    assert row["throttle_waits"] >= 3
    assert row["admitted"] == 5


def test_pressure_and_hedge_advisor():
    async def main():
        sched = QosScheduler(QosConfig.from_obj({}), read_capacity=4,
                             write_capacity=2, read_p99_objective_ms=100.0)
        assert sched.pressure() == 0.0
        assert sched.allow_hedge() is True
        await sched.acquire("read", OTHER)
        await sched.acquire("read", OTHER)
        assert sched.pressure() == 0.5
        assert sched.allow_hedge() is False
        sched.release("read")
        sched.release("read")
        for _ in range(32):
            sched.note_request("read", 0.010)
        assert sched.allow_hedge() is False
        for _ in range(32):
            sched.note_request("read", 0.095)
        assert sched.allow_hedge() is True
        stats = sched.stats()
        assert stats.hedge_suppressed == 1
        assert stats.hedge_conserved == 1

    arun(main())


def arrival_script(rng, n: int) -> list:
    """``n`` seeded arrivals: (virtual start s, tenant, class, byte cost
    or None, hold s)."""
    tenants = ("gold", "bulk", "slow", OTHER)
    script = []
    t = 0.0
    for _ in range(n):
        t += float(rng.exponential(0.02))
        tenant = tenants[int(rng.choice(4, p=(0.2, 0.5, 0.1, 0.2)))]
        cls = "write" if rng.random() < 0.2 else "read"
        cost = None if rng.random() < 0.1 else \
            int(rng.integers(1, 4 * 65536))
        script.append((round(t, 6), tenant, cls, cost,
                       round(float(rng.exponential(0.08)), 6)))
    return script


QOS_TABLE = {"tenants": {
    "gold": {"weight": 4, "keys": ["k-gold"]},
    "bulk": {"weight": 1, "prefixes": ["/bulk/"]},
    "slow": {"rate_bytes_per_sec": 200_000, "keys": ["k-slow"]},
}, "other": {"weight": 2}}


def run_script(config_cls, sched_cls, shed_cls, sim_run, clock, script):
    """Drive ``script`` through one package's scheduler under its own
    ``sim.run``: the grant log (virtual time, arrival index), shed
    arrivals and the final stats."""

    async def main():
        sched = sched_cls(config_cls.from_obj(QOS_TABLE), read_capacity=3,
                          write_capacity=2, max_queue=6,
                          queue_timeout_s=2.0, read_p99_objective_ms=50.0)
        log, shed, hedges = [], [], []

        async def arrive(i, start, tenant, cls, cost, hold):
            await asyncio.sleep(start)
            try:
                await sched.acquire(cls, tenant, cost=cost)
            except shed_cls:
                shed.append((round(clock.monotonic(), 6), i))
                return
            log.append((round(clock.monotonic(), 6), i))
            hedges.append((sched.pressure(), sched.allow_hedge()))
            try:
                await asyncio.sleep(hold)
            finally:
                sched.note_request(cls, hold)
                sched.release(cls)

        await asyncio.gather(*(arrive(i, *a) for i, a in enumerate(script)))
        return log, shed, hedges, sched.stats().to_obj(), str(sched.stats())

    return sim_run(main())


def test_scheduler_equals_jax_on_a_scripted_arrival_sequence():
    """One seeded script through both packages' schedulers, each under its
    own ``sim.run``: the same grants in the same order at the same virtual
    times, the same sheds, hedge verdicts and stats."""
    from chunky_bits_tpu.cluster.qos import QosConfig as JaxConfig
    from chunky_bits_tpu.cluster.qos import QosScheduler as JaxScheduler
    from chunky_bits_tpu.cluster.qos import QosShedError as JaxShed
    from chunky_bits_tpu.sim import run as jax_sim_run
    from chunky_bits_tpu.utils import clock as jax_clock
    from chunky_bits_tpu_torch.sim import run as sim_run
    from chunky_bits_tpu_torch.utils import clock

    script = arrival_script(np.random.default_rng(SEED), 400)
    ours = run_script(QosConfig, QosScheduler, QosShedError, sim_run, clock,
                      script)
    theirs = run_script(JaxConfig, JaxScheduler, JaxShed, jax_sim_run,
                        jax_clock, script)
    assert ours[0] == theirs[0]  # grant order and virtual grant times
    assert ours[1] == theirs[1]  # sheds
    assert ours[2] == theirs[2]  # pressure and hedge verdict per grant
    assert ours[3] == theirs[3] and ours[4] == theirs[4]
    # the script exercises queueing, shedding and the rate bucket
    rows = ours[3]["tenants"]
    assert ours[1], "no arrival shed"
    assert len(ours[0]) + len(ours[1]) == len(script)
    assert rows["slow"]["throttle_waits"] > 0
    assert max(r["queue_peak"] for r in rows.values()) > 1
    assert [i for _t, i in ours[0]] != sorted(i for _t, i in ours[0])


# ---- downstream hooks ----

def test_hedge_gate_denial_consumes_no_budget_token():
    board = HealthScoreboard(hedge_ms=10.0)
    for _ in range(100):
        board.note_primary()
    assert board.try_fire_hedge() is True
    fired_before = board.stats().hedges_fired
    board.set_hedge_gate(lambda: False)
    assert board.hedge_allowed() is False
    for _ in range(10):
        assert board.try_fire_hedge() is False
    board.set_hedge_gate(None)
    assert board.hedge_allowed() is True
    assert board.try_fire_hedge() is True
    assert board.stats().hedges_fired == fired_before + 1


def test_token_bucket_pressure_scales_accrual():
    from chunky_bits_tpu_torch.sim import run as sim_run
    from chunky_bits_tpu_torch.utils import clock as clock_mod

    async def take_seconds(pressure_fn) -> float:
        bucket = TokenBucket(1000.0)
        if pressure_fn is not None:
            bucket.set_pressure(pressure_fn)
        await bucket.take(1000.0)
        t0 = clock_mod.monotonic()
        await bucket.take(1000.0)
        return clock_mod.monotonic() - t0

    free = sim_run(take_seconds(None))
    half = sim_run(take_seconds(lambda: 0.5))
    full = sim_run(take_seconds(lambda: 1.0))
    assert 0.9 <= free <= 1.5, free
    assert 1.8 <= half <= 2.6, half
    assert 18.0 <= full <= 25.0, full


# ---- tunables ----

def test_tunables_qos_mapping_round_trip_and_validation():
    from chunky_bits_tpu.cluster.tunables import Tunables as JaxTunables

    obj = {"qos": {"enabled": True, "tenants": {"gold": {"weight": 2}}}}
    t = tunables_mod.Tunables.from_obj(obj)
    assert t.qos["enabled"] is True
    assert t.to_obj()["qos"] == obj["qos"]
    assert t.to_obj() == JaxTunables.from_obj(obj).to_obj()
    t2 = tunables_mod.Tunables.from_obj({})
    assert t2.qos == {}
    assert "qos" not in t2.to_obj()
    with pytest.raises(SerdeError, match="invalid qos mapping"):
        tunables_mod.Tunables.from_obj(
            {"qos": {"tenants": {"a": {"nope": 1}}}})


def test_qos_enabled_env_accessor(monkeypatch):
    monkeypatch.delenv(tunables_mod.QOS_ENV, raising=False)
    assert tunables_mod.qos_enabled() is False
    monkeypatch.setenv(tunables_mod.QOS_ENV, "1")
    assert tunables_mod.qos_enabled() is True
    monkeypatch.setenv(tunables_mod.QOS_ENV, "0")
    assert tunables_mod.qos_enabled() is False
    monkeypatch.delenv(tunables_mod.QOS_ENV)
    monkeypatch.setenv("CHUNKY_BITS_TPU_QOS", "1")
    assert tunables_mod.qos_enabled() is False


# ---- the gateway ----

def cluster_spec(tmp_path, qos: dict, backend="torch") -> dict:
    dirs = []
    for i in range(5):
        d = tmp_path / f"disk{i}"
        d.mkdir(exist_ok=True)
        dirs.append(str(d))
    meta = tmp_path / "meta"
    meta.mkdir(exist_ok=True)
    return {
        "destinations": [{"location": d} for d in dirs],
        "metadata": {"type": "path", "format": "yaml", "path": str(meta)},
        "profiles": {"default": {"data": 3, "parity": 2, "chunk_size": 12}},
        "tunables": {"backend": backend, **({"qos": qos} if qos else {})},
    }


def make_cluster(tmp_path, qos: dict):
    from chunky_bits_tpu_torch.cluster import Cluster

    return Cluster.from_obj(cluster_spec(tmp_path, qos))


QOS_YAML = {
    "enabled": True,
    "tenants": {
        "gold": {"weight": 4, "keys": ["k-gold"]},
        "bulk": {"prefixes": ["/bulk/"]},
    },
}


def test_gateway_tenant_resolution_log_split_and_metrics(tmp_path,
                                                         fresh_registry):
    from aiohttp.test_utils import TestClient, TestServer

    from chunky_bits_tpu_torch.file.profiler import (Profiler,
                                                     tenant_request_stats)
    from chunky_bits_tpu_torch.gateway import make_app

    payload = os.urandom(30000)
    profiler = Profiler()

    async def main():
        cluster = make_cluster(tmp_path, QOS_YAML)
        app = make_app(cluster, profiler=profiler)
        async with TestClient(TestServer(app)) as client:
            r = await client.put("/bulk/obj", data=payload,
                                 headers={"X-Api-Key": "k-gold"})
            assert r.status == 200
            for _ in range(2):
                r = await client.get("/bulk/obj",
                                     headers={"X-Api-Key": "k-gold"})
                assert await r.read() == payload
            r = await client.get("/bulk/obj")
            assert await r.read() == payload
            r = await client.get("/bulk/obj",
                                 headers={"X-Api-Key": "k-stale"})
            assert await r.read() == payload
            stats = await (await client.get("/stats")).json()
            metrics = await (await client.get("/metrics")).text()
        await cluster.tunables.location_context().aclose()
        return stats, metrics

    stats, metrics = arun(main())
    by_tenant = stats["requests_by_tenant"]
    assert by_tenant["gold"]["count"] == 3
    assert by_tenant["bulk"]["count"] == 2
    split = tenant_request_stats(profiler.peek_requests())
    assert split["gold"].count == 3
    assert split["bulk"].count == 2
    assert OTHER in split
    qos = stats["qos"]
    assert qos["enabled"] is True
    assert set(qos["tenants"]) == {"gold", "bulk", OTHER}
    assert qos["tenants"]["gold"]["admitted"] == 3
    assert qos["tenants"]["bulk"]["admitted"] == 2
    assert 'cb_qos_admitted_total{tenant="gold"} 3' in metrics
    assert 'cb_qos_admitted_total{tenant="bulk"} 2' in metrics
    assert "cb_qos_pressure" in metrics
    assert 'qos="on"' in metrics
    obs_metrics.parse_exposition(metrics)


def test_gateway_qos_off_is_zero_overhead(tmp_path):
    """Off by default: in a fresh interpreter a plain gateway imports none
    of ``obs/slo.py``, ``cluster/qos.py`` and ``gateway/qos.py``, mints no
    qos label set, and ``/stats`` says ``enabled: false``."""
    code = """
import asyncio, os, sys
from aiohttp.test_utils import TestClient, TestServer
from chunky_bits_tpu_torch.cluster import Cluster
from chunky_bits_tpu_torch.gateway import make_app

root = sys.argv[1]
dirs = []
for i in range(5):
    d = os.path.join(root, f"disk{i}")
    os.makedirs(d); dirs.append(d)
meta = os.path.join(root, "meta"); os.makedirs(meta)
cluster = Cluster.from_obj({
    "destinations": [{"location": d} for d in dirs],
    "metadata": {"type": "path", "format": "yaml", "path": meta},
    "profiles": {"default": {"data": 3, "parity": 2, "chunk_size": 12}},
    "tunables": {"backend": "torch"},
})

async def main():
    app = make_app(cluster)
    async with TestClient(TestServer(app)) as client:
        assert (await client.put("/x", data=b"hello")).status == 200
        r = await client.get("/x")
        assert await r.read() == b"hello"
        stats = await (await client.get("/stats")).json()
        metrics = await (await client.get("/metrics")).text()
        alerts = await (await client.get("/alerts")).json()
    assert stats["qos"] == {"enabled": False}
    assert stats["slo"] == {"enabled": False}
    assert alerts == {"enabled": False}
    assert "requests_by_tenant" not in stats
    assert "cb_qos_" not in metrics and "cb_alerts_" not in metrics
    assert 'qos="off"' in metrics and 'slo="off"' in metrics
    await cluster.tunables.location_context().aclose()

asyncio.run(main())
for mod in ("chunky_bits_tpu_torch.cluster.qos",
            "chunky_bits_tpu_torch.gateway.qos",
            "chunky_bits_tpu_torch.obs.slo",
            "chunky_bits_tpu_torch.sim"):
    assert mod not in sys.modules, mod + " imported"
print("OK")
"""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CHUNKY_BITS_")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       capture_output=True, timeout=120, env=env)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"OK" in r.stdout


def test_gateway_shed_has_derived_retry_after(tmp_path, fresh_registry):
    from aiohttp.test_utils import TestClient, TestServer

    from chunky_bits_tpu_torch.gateway import make_app
    from chunky_bits_tpu_torch.gateway import http as gw

    payload = os.urandom(30000)

    async def main():
        cluster = make_cluster(tmp_path, {"enabled": False})
        app = make_app(cluster, max_concurrent_gets=1)
        async with TestClient(TestServer(app)) as client:
            assert (await client.put("/obj", data=payload)).status == 200
            for _ in range(3):
                await (await client.get("/obj")).read()
            statuses, retry_after = [], []
            real = cluster.file_read_builder

            def slow_builder(ref):
                # hold each body a moment, so the bound is reached
                builder = real(ref)
                stream = builder.stream

                async def slowed():
                    await asyncio.sleep(0.05)
                    async for piece in stream():
                        yield piece

                builder.stream = slowed
                return builder

            cluster.file_read_builder = slow_builder

            async def one():
                r = await client.get("/obj")
                statuses.append(r.status)
                if r.status == 503:
                    retry_after.append(r.headers["Retry-After"])
                await r.read()

            await asyncio.gather(*[one() for _ in range(8)])
        await cluster.tunables.location_context().aclose()
        return statuses, retry_after

    assert gw.DEFAULT_MAX_CONCURRENT_GETS > 1
    statuses, retry_after = arun(main())
    assert 503 in statuses and 200 in statuses
    for value in retry_after:
        assert value.isdigit() and int(value) >= 1


def test_gateway_qos_write_shed_and_tenant_queueing(tmp_path,
                                                    fresh_registry):
    from aiohttp.test_utils import TestClient, TestServer

    from chunky_bits_tpu_torch.gateway import make_app

    payload = os.urandom(30000)

    async def main():
        cluster = make_cluster(tmp_path, QOS_YAML)
        app = make_app(cluster, max_concurrent_gets=2)
        async with TestClient(TestServer(app)) as client:
            assert (await client.put(
                "/bulk/obj", data=payload,
                headers={"X-Api-Key": "k-gold"})).status == 200

            async def read(key: str) -> int:
                r = await client.get(
                    "/bulk/obj", headers={"X-Api-Key": key} if key else {})
                await r.read()
                return r.status

            statuses = await asyncio.gather(
                *[read("k-gold") for _ in range(6)],
                *[read("") for _ in range(6)])
            assert statuses == [200] * 12
            stats = await (await client.get("/stats")).json()
        await cluster.tunables.location_context().aclose()
        return stats

    tenants = arun(main())["qos"]["tenants"]
    assert tenants["gold"]["admitted"] >= 6
    assert tenants["bulk"]["admitted"] >= 6
    assert tenants["gold"]["shed"] == 0
    assert tenants["bulk"]["shed"] == 0


def test_gateway_tenants_and_qos_lines_equal_the_jax_gateway(tmp_path):
    """The same requests (tenants by key, by prefix and unmatched, PUTs
    and GETs) through a JAX gateway (``numpy``) and the port's (``torch``)
    with QoS on, each with its own Cluster over one tree and a registry of
    its own: equal per-tenant access-log counts and byte totals, equal
    ``qos`` stanzas and equal ``cb_qos_*`` exposition lines."""
    from aiohttp import web

    from chunky_bits_tpu.cluster import Cluster as JaxCluster
    from chunky_bits_tpu.file.profiler import Profiler as JaxProfiler
    from chunky_bits_tpu.file.profiler import \
        tenant_request_stats as jax_split
    from chunky_bits_tpu.gateway import make_app as jax_make_app
    from chunky_bits_tpu.obs import metrics as jax_metrics
    from chunky_bits_tpu_torch.cluster import Cluster
    from chunky_bits_tpu_torch.file.profiler import (Profiler,
                                                     tenant_request_stats)
    from chunky_bits_tpu_torch.gateway import make_app

    rng = np.random.default_rng(SEED)
    objects = {name: rng.integers(0, 256, n, dtype=np.uint8).tobytes()
               for name, n in (("bulk/a", 40000), ("b", 9000),
                               ("bulk/c", 70000))}
    requests = []
    for name, data in objects.items():
        requests.append(("PUT", f"/{name}", "k-gold" if name == "b" else "",
                         data))
    for i in range(24):
        name = list(objects)[int(rng.integers(0, 3))]
        key = ("k-gold", "", "k-nobody")[int(rng.integers(0, 3))]
        requests.append(("GET", f"/{name}", key, b""))

    async def start(app):
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return runner, site._server.sockets[0].getsockname()[1]

    async def drive(session, port):
        for method, path, key, data in requests:
            headers = {"X-Api-Key": key} if key else {}
            async with session.request(method, f"http://127.0.0.1:{port}"
                                       f"{path}", data=data or None,
                                       headers=headers) as r:
                body = await r.read()
                assert r.status == 200, (method, path)
                if method == "GET":
                    assert body == objects[path[1:]]
        async with session.get(f"http://127.0.0.1:{port}/stats") as r:
            stats = await r.json()
        async with session.get(f"http://127.0.0.1:{port}/metrics") as r:
            text = await r.text()
        return stats, sorted(ln for ln in text.splitlines()
                             if ln.startswith("cb_qos_"))

    async def main():
        import aiohttp

        out = []
        for cls, app_fn, prof, backend in (
                (JaxCluster, jax_make_app, JaxProfiler(), "numpy"),
                (Cluster, make_app, Profiler(), "torch")):
            root = tmp_path / backend
            root.mkdir()
            cluster = cls.from_obj(cluster_spec(root, QOS_YAML, backend))
            runner, port = await start(app_fn(cluster, profiler=prof))
            try:
                async with aiohttp.ClientSession() as session:
                    out.append((*await drive(session, port), prof))
            finally:
                await runner.cleanup()
            await cluster.tunables.location_context().aclose()
        return out

    restore = swap_registries(obs_metrics, jax_metrics)
    try:
        (theirs, theirs_lines, jprof), (ours, ours_lines, prof) = \
            arun(main())
    finally:
        restore()
    assert ours["qos"] == theirs["qos"]
    assert ours_lines == theirs_lines
    assert any('tenant="gold"' in ln for ln in ours_lines)
    for split in (ours["requests_by_tenant"], theirs["requests_by_tenant"]):
        for row in split.values():
            for key in ("p50_ms", "p99_ms", "p999_ms"):
                row.pop(key)
    assert ours["requests_by_tenant"] == theirs["requests_by_tenant"]
    # the access logs, but for the /stats and /metrics scrapes (whose
    # bodies carry each package's own families)
    scrapes = ("/stats", "/metrics")
    mine = {t: (s.count, s.total_bytes) for t, s in tenant_request_stats(
        [e for e in prof.peek_requests() if e.path not in scrapes]).items()}
    assert mine == {t: (s.count, s.total_bytes) for t, s in jax_split(
        [e for e in jprof.peek_requests()
         if e.path not in scrapes]).items()}
    assert set(mine) == {"gold", "bulk", OTHER}
