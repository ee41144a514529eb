"""The port's metrics plane (``chunky_bits_tpu_torch.obs.metrics``) held
against the JAX package's: exposition, its grammar check, the fleet
merge, the snapshot spool, the loop-lag monitor, the polled sources, and
the cases of ``tests/test_obs.py`` that need no SLO engine.

The same records (counters, gauges, histograms, and stat sources with
fixed numbers) go into one registry of each package, and the two
Prometheus texts must be byte-equal; each package's parser accepts the
other's output.
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import time

import pytest

from chunky_bits_tpu.obs import metrics as jm
from chunky_bits_tpu_torch.obs import metrics as pm
from chunky_bits_tpu_torch.obs.metrics import (
    ExpositionError,
    LoopLagMonitor,
    MetricsRegistry,
    merge_snapshots,
    parse_exposition,
    render_exposition,
)


def arun(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class _Stats:
    def __init__(self, obj):
        self._obj = obj

    def to_obj(self):
        return dict(self._obj)


class FixedSource:
    """A stat source with fixed numbers, registrable in either package."""

    def __init__(self, obj):
        self._obj = obj

    def stats(self):
        return _Stats(self._obj)


CACHE = {"hits": 7, "misses": 3, "coalesced": 1, "inserts": 3,
         "evictions": 1, "rejects": 0, "size_bytes": 4096,
         "capacity_bytes": 1 << 20, "entries": 2}
PIPELINE = {"threads": 4, "idle_s": 1.25, "stages": [
    {"stage": "verify", "jobs": 9, "busy_s": 0.5, "nbytes": 1 << 20},
    {"stage": "encode", "jobs": 2, "busy_s": 0.125, "nbytes": 65536}]}
HEALTH = {"hedges_fired": 2, "hedges_won": 1, "hedges_cancelled": 1,
          "primaries": 40, "locations": [
              {"node": "/d0", "completions": 20, "errors": 1,
               "inflight": 0, "err_rate": 0.05, "ewma_ms": 1.5,
               "breaker": "closed"},
              {"node": "/d1", "completions": 19, "errors": 0,
               "inflight": 2, "err_rate": 0.0, "ewma_ms": None,
               "breaker": "half-open"}]}


def record_the_same(mod, reg, sources):
    reg.counter("t_total", "a counter", labels=("k",)).labels(
        k='we"ird\\v').inc(2)
    reg.counter("t_total", "a counter", labels=("k",)).labels(k="b").inc()
    reg.gauge("t_gauge", "a gauge").set(-3.5)
    hist = reg.histogram("t_seconds", "a hist", labels=("op",))
    for v in (0.0001, 0.003, 0.003, 0.9, 250.0):
        hist.labels(op="read").observe(v)
    reg.histogram("t_small", "custom buckets", buckets=(0.1, 1.0)) \
        .observe(0.05)
    mod.record_build_info("0.1.0", "cuda", {"code": "rs",
                                            "sendfile": "on"}, reg)
    for kind, src in sources:
        reg.register_source(kind, src)


def both_registries():
    sources = [("cache", FixedSource(CACHE)),
               ("pipeline", FixedSource(PIPELINE)),
               ("health", FixedSource(HEALTH))]
    ours, theirs = pm.MetricsRegistry(), jm.MetricsRegistry()
    record_the_same(pm, ours, sources)
    record_the_same(jm, theirs, sources)
    return ours, theirs, sources


def test_render_exposition_equals_the_jax_package():
    ours, theirs, _sources = both_registries()
    text = render_exposition(ours.snapshot())
    assert text == jm.render_exposition(theirs.snapshot())
    assert ours.render() == theirs.render()
    for name in ("cb_cache_hits_total", "cb_pipeline_busy_seconds_total",
                 "cb_node_breaker_state", "cb_hedge_primaries_total",
                 "cb_build_info", "t_seconds"):
        assert f"# TYPE {name} " in text, name


def test_each_parser_accepts_the_others_output():
    ours, theirs, _sources = both_registries()
    mine, other = ours.render(), theirs.render()
    assert parse_exposition(other) == jm.parse_exposition(mine)
    parsed = parse_exposition(mine)
    assert parsed["t_total"]["type"] == "counter"
    values = {labels["k"]: value
              for _n, labels, value in parsed["t_total"]["samples"]}
    assert values == {"b": 1.0, 'we\\"ird\\\\v': 2.0}


@pytest.mark.parametrize("bad", [
    "orphan_metric 1\n",
    "# TYPE x counter\nx -1\n",
    "# TYPE x counter\nx{k=unquoted} 1\n",
    "# TYPE x counter\n# TYPE x counter\nx 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 1\nh_sum 1\nh_count 1\n",
    "# TYPE h histogram\nh_bucket{le=\"1\"} 5\nh_bucket{le=\"+Inf\"} 3\n"
    "h_sum 1\nh_count 3\n",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 3\nh_sum 1\nh_count 4\n",
    "# WEIRD comment\n",
])
def test_exposition_grammar_rejects(bad):
    with pytest.raises(ExpositionError):
        parse_exposition(bad)
    with pytest.raises(jm.ExpositionError):
        jm.parse_exposition(bad)


def test_merge_snapshots_equals_the_jax_package():
    def snap(mod, v):
        reg = mod.MetricsRegistry()
        reg.counter("m_total", labels=("k",)).labels(k="a").inc(v)
        reg.histogram("m_seconds", buckets=(1.0,)).observe(v)
        reg.gauge("m_gauge").set(v)
        return reg.snapshot()

    merged = merge_snapshots([("w1", snap(pm, 1)), ("w2", snap(pm, 2))])
    assert merged == jm.merge_snapshots(
        [("w1", snap(jm, 1)), ("w2", snap(jm, 2))])
    fams = {f["name"]: f for f in merged["families"]}
    assert fams["m_total"]["samples"] == [
        {"labels": {"k": "a"}, "value": 3.0}]
    hist = fams["m_seconds"]["samples"][0]
    assert hist["count"] == 2 and hist["sum"] == 3.0
    assert {s["labels"]["worker"]: s["value"]
            for s in fams["m_gauge"]["samples"]} == {"w1": 1.0, "w2": 2.0}
    parse_exposition(render_exposition(merged))
    # single process: gauges stay unlabeled
    single = merge_snapshots([(None, snap(pm, 4))])
    assert {f["name"]: f for f in single["families"]}["m_gauge"][
        "samples"] == [{"labels": {}, "value": 4.0}]


def test_merge_rejects_bucket_layout_mismatch():
    reg1, reg2 = MetricsRegistry(), MetricsRegistry()
    reg1.histogram("m_seconds", buckets=(1.0,)).observe(0.5)
    reg2.histogram("m_seconds", buckets=(2.0,)).observe(0.5)
    with pytest.raises(ValueError):
        merge_snapshots([("a", reg1.snapshot()), ("b", reg2.snapshot())])


@pytest.mark.parametrize("q", [0.0, 25.0, 50.0, 90.0, 99.0, 100.0])
def test_histogram_quantile_equals_the_jax_package(q):
    bounds = pm.DEFAULT_TIME_BUCKETS
    counts = [0] * (len(bounds) + 1)
    for i, c in ((0, 3), (4, 10), (9, 2), (len(bounds), 1)):
        counts[i] = c
    assert pm.histogram_quantile(bounds, counts, q) == \
        jm.histogram_quantile(bounds, counts, q)
    assert pm.histogram_quantile(bounds, [0] * len(counts), q) == 0.0


def test_spool_write_load_fleet(tmp_path):
    """A port worker's spooled snapshot merges with a JAX one; a torn
    file is skipped; ``own`` replaces a stale spool entry."""
    spool = str(tmp_path / "spool")
    os.makedirs(spool)
    reg = MetricsRegistry()
    reg.counter("s_total").inc(5)
    pm.write_snapshot_file(os.path.join(spool, "worker-1.json"),
                           reg.snapshot())
    with open(os.path.join(spool, "worker-2.json"), "w") as f:
        f.write("{torn")
    jreg = jm.MetricsRegistry()
    jreg.counter("s_total").inc(11)
    jm.write_snapshot_file(os.path.join(spool, "worker-4.json"),
                           jreg.snapshot())
    assert [wid for wid, _s in pm.load_spool(spool)] == ["1", "4"]
    assert pm.load_spool(spool) == jm.load_spool(spool)
    reg2 = MetricsRegistry()
    reg2.counter("s_total").inc(7)
    fams = {f["name"]: f for f in pm.fleet_snapshot(
        spool, own=("3", reg2.snapshot()))["families"]}
    assert fams["s_total"]["samples"][0]["value"] == 23.0
    fams = {f["name"]: f for f in pm.fleet_snapshot(
        spool, own=("1", reg2.snapshot()))["families"]}
    assert fams["s_total"]["samples"][0]["value"] == 18.0
    assert pm.load_spool(str(tmp_path / "absent")) == []


def test_health_and_cache_sources_are_exact(tmp_path):
    """The port's own scoreboard and cache as sources: per-node counts
    appear verbatim, and two sources of one kind sum."""
    from chunky_bits_tpu_torch.cluster.health import HealthScoreboard
    from chunky_bits_tpu_torch.file.chunk_cache import ChunkCache
    from chunky_bits_tpu_torch.file.location import Location

    loc = Location.local(str(tmp_path / "disk" / "x"))

    def scoreboard():
        sb = HealthScoreboard()
        sb.record(loc, True, 0.01)
        sb.record(loc, True, 0.02)
        sb.record(loc, False)
        return sb

    reg = MetricsRegistry()
    sb1 = scoreboard()
    reg.register_source("health", sb1)
    fams = {f["name"]: f for f in reg.snapshot()["families"]}
    assert fams["cb_node_completions_total"]["samples"][0]["value"] == 3
    assert fams["cb_node_errors_total"]["samples"][0]["value"] == 1
    sb2 = scoreboard()
    reg.register_source("health", sb2)
    fams = {f["name"]: f for f in reg.snapshot()["families"]}
    assert fams["cb_node_completions_total"]["samples"][0]["value"] == 6
    cache = ChunkCache(1 << 20)
    reg.register_source("cache", cache)
    cache._insert(b"k" * 32, b"v" * 100)
    assert cache.get(b"k" * 32) == b"v" * 100
    fams = {f["name"]: f for f in reg.snapshot()["families"]}
    assert fams["cb_cache_hits_total"]["samples"][0]["value"] == 1
    assert fams["cb_cache_size_bytes"]["samples"][0]["value"] == 100
    del cache
    assert "cb_cache_hits_total" not in {
        f["name"] for f in reg.snapshot()["families"]}


def test_loop_lag_monitor_observes_a_blocked_loop():
    reg = MetricsRegistry()

    async def main():
        mon = LoopLagMonitor(reg, interval=0.05)
        mon.start(asyncio.get_running_loop())
        try:
            await asyncio.sleep(0.1)
            time.sleep(0.3)  # block the loop on purpose
            await asyncio.sleep(0.1)
        finally:
            mon.stop()

    arun(main())
    hist = {f["name"]: f for f in reg.snapshot()["families"]}[
        "cb_eventloop_lag_seconds"]["samples"][0]
    assert hist["count"] >= 2 and hist["sum"] >= 0.2


def test_find_family_and_build_info():
    reg = MetricsRegistry()
    pm.record_build_info("0.1.0", "", {"qos": "off"}, reg)
    snap = reg.snapshot()
    fam = pm.find_family(snap, "cb_build_info")
    assert fam["samples"][0]["labels"] == {
        "version": "0.1.0", "backend": "auto", "qos": "off"}
    assert pm.find_family(snap, "nope") is None


def test_tunables_trace_slow_ms_and_cache_bytes(monkeypatch):
    from chunky_bits_tpu_torch.cluster.tunables import (
        CACHE_BYTES_ENV, TRACE_SLOW_MS_ENV, Tunables, trace_slow_ms)
    from chunky_bits_tpu_torch.errors import SerdeError

    monkeypatch.delenv(TRACE_SLOW_MS_ENV, raising=False)
    monkeypatch.delenv(CACHE_BYTES_ENV, raising=False)
    assert trace_slow_ms() == 0.0 and Tunables().trace_slow_ms == 0.0
    monkeypatch.setenv(TRACE_SLOW_MS_ENV, "12.5")
    assert Tunables().trace_slow_ms == 12.5
    monkeypatch.setenv(TRACE_SLOW_MS_ENV, "garbage")
    assert trace_slow_ms() == 0.0
    t = Tunables.from_obj({"trace_slow_ms": 40, "cache_bytes": 1 << 20})
    assert (t.trace_slow_ms, t.cache_bytes) == (40.0, 1 << 20)
    back = Tunables.from_obj(t.to_obj())
    assert (back.trace_slow_ms, back.cache_bytes) == (40.0, 1 << 20)
    for bad in ({"trace_slow_ms": -1}, {"cache_bytes": -1}):
        with pytest.raises(SerdeError):
            Tunables.from_obj(bad)


def test_stats_cli_against_a_port_gateway(tmp_path):
    """``stats_command`` renders a port gateway's surface, text and JSON,
    and fails loudly on an unreachable one."""
    from chunky_bits_tpu_torch.cli.stats import stats_command
    from chunky_bits_tpu_torch.errors import ChunkyBitsError
    from tests.test_torch_gateway import make_cluster

    async def main():
        import aiohttp
        from aiohttp.test_utils import TestServer

        from chunky_bits_tpu_torch.gateway import make_app

        cluster = make_cluster(tmp_path)
        server = TestServer(make_app(cluster))
        await server.start_server()
        try:
            url = f"http://127.0.0.1:{server.port}"
            async with aiohttp.ClientSession() as session:
                assert (await session.put(f"{url}/obj",
                                          data=b"y" * 5000)).status == 200
                await (await session.get(f"{url}/obj")).read()
            out = io.StringIO()
            assert await stats_command(url, as_json=False, out=out) == 0
            text = out.getvalue()
            assert "requests: n=" in text and "status=ok" in text
            assert "scrub: disabled" in text
            out = io.StringIO()
            assert await stats_command(url, as_json=True, out=out) == 0
            blob = json.loads(out.getvalue())
            assert blob["healthz"]["status"] == "ok"
            assert blob["stats"]["requests"]["count"] >= 2
        finally:
            await server.close()
        with pytest.raises(ChunkyBitsError):
            await stats_command("http://127.0.0.1:1", as_json=False,
                                out=io.StringIO())
        await cluster.tunables.location_context().aclose()

    arun(main())
