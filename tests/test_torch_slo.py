"""The port's SLO engine (``chunky_bits_tpu_torch/obs/slo.py``), held
against the cases of ``tests/test_slo.py`` and against the JAX package's
engine.

The cases of the JAX suite run on the port as they stand there (the
windowed views of ``SnapshotRing``, the alert state machine, the fleet
merge, the gateway's ``/alerts`` and ``/stats``, the profiler stanza and
the stats CLI).  Beside them: one seeded sequence of registry snapshots
(numpy, ``SEED``) fed to both packages' ``SloEngine``s at the same
``now``s must give equal alert states, windowed values, transitions,
history, ``to_obj()`` and published ``cb_slo_*``/``cb_alerts_*`` lines at
every step (exact equality); ``SloObjectives.from_obj`` accepts and
refuses the same mappings; and raw requests to a JAX gateway (``numpy``
backend) and to the port's (``torch``), both with the engine on, answer
equal ``/alerts`` and ``slo`` stanzas.  Every gateway test runs on a
registry of its own (``fresh_registry``): the process-wide registry would
otherwise carry this file's ``slo="on"`` build rows into other files'
tests.  Every event loop runs under a deadline (``arun``).
"""

import asyncio
import io
import json
import math
import os

import numpy as np
import pytest

from chunky_bits_tpu_torch.obs import metrics as obs_metrics
from chunky_bits_tpu_torch.obs import slo as obs_slo
from chunky_bits_tpu_torch.obs.metrics import (
    MetricsRegistry,
    histogram_quantile,
    parse_exposition,
)
from chunky_bits_tpu_torch.obs.slo import (
    FIRING,
    INACTIVE,
    PENDING,
    RULES,
    SloEngine,
    SloObjectives,
    SnapshotRing,
    fleet_alert_states,
)

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


def cluster_spec(tmp_path, backend="torch", **tunables) -> dict:
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
        "profiles": {"default": {"data": 3, "parity": 2, "chunk_size": 16}},
        "tunables": {"backend": backend, **tunables},
    }


def make_cluster(tmp_path, **tunables):
    from chunky_bits_tpu_torch.cluster import Cluster

    return Cluster.from_obj(cluster_spec(tmp_path, **tunables))


# ---- histogram_quantile edge cases ----

def test_histogram_quantile_empty_is_zero():
    assert histogram_quantile((0.1, 1.0), [0, 0, 0], 99.0) == 0.0
    assert histogram_quantile((), [], 50.0) == 0.0


def test_histogram_quantile_all_mass_in_inf_bucket():
    bounds = (0.1, 1.0)
    counts = [0, 0, 10]
    q50 = histogram_quantile(bounds, counts, 50.0)
    q99 = histogram_quantile(bounds, counts, 99.0)
    assert 1.0 <= q50 <= 2.0 and 1.0 <= q99 <= 2.0
    assert q50 <= q99
    assert math.isfinite(q99)
    only_inf = histogram_quantile((), [5], 99.0)
    assert 0.0 <= only_inf <= 1.0 and math.isfinite(only_inf)


def test_histogram_quantile_single_sample():
    bounds = (0.1, 1.0, 10.0)
    counts = [0, 1, 0, 0]
    for q in (1.0, 50.0, 99.9):
        v = histogram_quantile(bounds, counts, q)
        assert 0.1 <= v <= 1.0, (q, v)


# ---- SnapshotRing ----

def _counter_fam(name, *samples):
    return {"name": name, "type": "counter", "help": "",
            "samples": [{"labels": dict(labels), "value": value}
                        for labels, value in samples]}


def _gauge_fam(name, *samples):
    fam = _counter_fam(name, *samples)
    fam["type"] = "gauge"
    return fam


def _hist_fam(name, buckets, counts, labels=()):
    return {"name": name, "type": "histogram", "help": "",
            "buckets": list(buckets),
            "samples": [{"labels": dict(labels), "counts": list(counts),
                         "sum": 0.0, "count": sum(counts)}]}


def test_ring_counter_delta_and_window_selection():
    ring = SnapshotRing()
    for t, v in ((0, 100), (30, 160), (60, 220)):
        ring.append({"families": [_counter_fam("c_total", ((), v))]}, now=t)
    assert ring.counter_delta("c_total", 60) == 120
    assert ring.counter_delta("c_total", 30) == 60
    assert ring.counter_delta("nope_total", 60) is None


def test_ring_young_ring_reads_as_no_data():
    ring = SnapshotRing()
    ring.append({"families": [_counter_fam("c_total", ((), 5))]}, now=0)
    assert ring.counter_delta("c_total", 60) is None
    ring.append({"families": [_counter_fam("c_total", ((), 9))]}, now=10)
    assert ring.counter_delta("c_total", 60) is None
    assert ring.counter_delta("c_total", 20) == 4


def test_ring_counter_reset_is_a_fresh_epoch_not_negative():
    ring = SnapshotRing()
    ring.append({"families": [_counter_fam("c_total", ((), 1000))]}, now=0)
    ring.append({"families": [_counter_fam("c_total", ((), 50))]}, now=60)
    assert ring.counter_delta("c_total", 60) == 50


def test_ring_reset_is_per_label_set():
    key_a = (("worker", "a"),)
    key_b = (("worker", "b"),)
    ring = SnapshotRing()
    ring.append({"families": [_counter_fam(
        "c_total", (key_a, 500), (key_b, 300))]}, now=0)
    ring.append({"families": [_counter_fam(
        "c_total", (key_a, 700), (key_b, 20))]}, now=60)
    assert ring.counter_delta("c_total", 60) == 220


def test_ring_histogram_window_and_reset():
    ring = SnapshotRing()
    ring.append({"families": [_hist_fam("h", (0.1, 1.0), [10, 5, 1])]},
                now=0)
    ring.append({"families": [_hist_fam("h", (0.1, 1.0), [14, 9, 1])]},
                now=60)
    bounds, counts = ring.hist_window("h", 60)
    assert bounds == [0.1, 1.0] and counts == [4, 4, 0]
    ring.append({"families": [_hist_fam("h", (0.1, 1.0), [2, 1, 0])]},
                now=120)
    _, counts = ring.hist_window("h", 60)
    assert counts == [2, 1, 0]


def test_ring_quantile_over_window():
    ring = SnapshotRing()
    ring.append({"families": [_hist_fam("h", (0.1, 1.0), [100, 0, 0])]},
                now=0)
    ring.append({"families": [_hist_fam("h", (0.1, 1.0), [100, 50, 0])]},
                now=60)
    q = ring.quantile("h", 99.0, 60)
    assert 0.1 <= q <= 1.0
    assert ring.quantile("absent", 99.0, 60) is None


def test_ring_gauge_persistence():
    ring = SnapshotRing()

    def frac(snap):
        values = ring.gauge_values(snap, "g")
        if not values:
            return None
        return sum(1 for v in values if v >= 1) / len(values)

    for t, states in ((0, (0, 0)), (30, (1, 2)), (60, (1, 2))):
        ring.append({"families": [_gauge_fam(
            "g", *(((("node", str(i)),), v)
                   for i, v in enumerate(states)))]}, now=t)
    assert ring.gauge_persisted(60, frac) == 0.0
    assert ring.gauge_persisted(30, frac) == 1.0


def test_ring_prunes_by_age():
    ring = SnapshotRing(max_age_s=100.0)
    for t in range(0, 1000, 10):
        ring.append({"families": [_counter_fam("c_total",
                                               ((), float(t)))]}, now=t)
    assert len(ring) <= 13
    assert ring.counter_delta("c_total", 100) == 100.0


def _requests_snap(ok_total, err_total):
    return {"families": [_counter_fam(
        "cb_request_total",
        ((("method", "GET"), ("source", "store"),
          ("status_class", "2xx")), ok_total),
        ((("method", "GET"), ("source", "-"),
          ("status_class", "5xx")), err_total))]}


def test_worker_labeled_snapshot_restart_stays_windowed():
    from chunky_bits_tpu_torch.obs.slo import worker_labeled_snapshot

    def fleet(a_ok, a_err, b_ok, b_err):
        return worker_labeled_snapshot([
            ("a", _requests_snap(a_ok, a_err)),
            ("b", _requests_snap(b_ok, b_err)),
        ])

    eng = SloEngine(SloObjectives(fast_s=60, slow_s=120),
                    registry=MetricsRegistry())
    t, a_ok, b_ok, b_err = 0, 10_000, 10_000, 5_000
    while t <= 120:
        eng.observe(fleet(a_ok, 0, b_ok, b_err), now=t)
        t += 30
        a_ok += 30
        b_ok += 30
    assert {x.rule: x.state for x in eng.alerts()}[
        "availability"] == INACTIVE
    b_ok, b_err = 5, 0
    for _ in range(4):
        eng.observe(fleet(a_ok, 0, b_ok, b_err), now=t)
        t += 30
        a_ok += 30
        b_ok += 30
    alerts = {x.rule: x for x in eng.alerts()}
    assert alerts["availability"].state == INACTIVE, alerts["availability"]
    assert (alerts["availability"].value_fast or 0.0) < 0.01
    for _ in range(4):
        eng.observe(worker_labeled_snapshot(
            [("a", _requests_snap(a_ok, 0))]), now=t)
        t += 30
        a_ok += 30
    assert {x.rule: x.state for x in eng.alerts()}[
        "availability"] == INACTIVE


def test_worker_labeled_snapshot_shape():
    from chunky_bits_tpu_torch.obs.slo import worker_labeled_snapshot

    combined = worker_labeled_snapshot([
        ("a", {"families": [_gauge_fam("cb_worker_up", ((), 1))]}),
        ("b", {"families": [_gauge_fam("cb_worker_up", ((), 1))]}),
    ])
    fam = combined["families"][0]
    assert fam["name"] == "cb_worker_up"
    assert sorted(s["labels"]["worker"] for s in fam["samples"]) \
        == ["a", "b"]
    assert sum(s["value"] for s in fam["samples"]) == 2


# ---- objectives ----

def test_objectives_loud_on_unknown_and_invalid():
    with pytest.raises(ValueError, match="unknown slo objective"):
        SloObjectives.from_obj({"tpyo": 1})
    with pytest.raises(ValueError, match="must be >= 0"):
        SloObjectives.from_obj({"fast_s": -1})
    with pytest.raises(ValueError, match="mapping"):
        SloObjectives.from_obj([1])
    obj = SloObjectives.from_obj({"fast_s": 30, "min_workers": 2})
    assert obj.fast_s == 30.0 and obj.min_workers == 2
    assert SloObjectives.from_obj(obj.to_obj()).to_obj() == obj.to_obj()


#: mappings both packages must accept (equal to_obj) or refuse (the same
#: message)
OBJECTIVE_CASES = (
    None, {}, {"fast_s": 30, "min_workers": 2}, {"read_p99_ms": "250"},
    {"clear_s": 0, "for_s": 5.5}, {"min_workers": "3"},
    {"tpyo": 1}, {"fast_s": -1}, [1], "fast_s", {"slow_s": "soon"},
    {"min_workers": 1.5}, {"hedge_fire_ratio": None}, {"min_workers": -2},
)


@pytest.mark.parametrize("obj", OBJECTIVE_CASES,
                         ids=[repr(c) for c in OBJECTIVE_CASES])
def test_objectives_from_obj_equals_jax(obj):
    from chunky_bits_tpu.obs.slo import SloObjectives as JaxObjectives

    def parse(cls):
        try:
            return "ok", cls.from_obj(obj).to_obj()
        except ValueError as err:
            return "error", str(err)

    assert parse(SloObjectives) == parse(JaxObjectives)


# ---- the state machine ----

def test_fast_window_spike_alone_never_fires():
    eng = SloEngine(SloObjectives(fast_s=60, slow_s=300),
                    registry=MetricsRegistry())
    eng.observe(_requests_snap(100, 0), now=0)
    eng.observe(_requests_snap(150, 50), now=60)
    assert {a.rule: a.state for a in eng.alerts()}["availability"] \
        == INACTIVE


def test_availability_fires_and_resolves_with_hysteresis():
    eng = SloEngine(SloObjectives(fast_s=60, slow_s=300, clear_s=120),
                    registry=MetricsRegistry())
    ok, err, t = 100, 0, 0
    while t <= 300:
        eng.observe(_requests_snap(ok, err), now=t)
        t += 30
        ok += 27
        err += 3
    alerts = {a.rule: a for a in eng.alerts()}
    assert alerts["availability"].state == FIRING
    assert alerts["availability"].value_fast == pytest.approx(0.1)
    fired_at = alerts["availability"].since
    clean_since = None
    while t <= 900:
        eng.observe(_requests_snap(ok, err), now=t)
        state = {a.rule: a.state for a in eng.alerts()}
        ratio = eng.alerts()[0].value_fast
        if clean_since is None and ratio is not None and ratio < 0.01:
            clean_since = t
        if state["availability"] == INACTIVE:
            break
        t += 30
        ok += 30
    assert {a.rule: a.state for a in eng.alerts()}["availability"] \
        == INACTIVE
    assert clean_since is not None
    assert t - clean_since >= 120, "resolved before the hold-down"
    history = eng.history()
    assert len(history) == 1
    assert history[0]["rule"] == "availability"
    assert history[0]["fired_at"] == pytest.approx(fired_at)
    assert history[0]["resolved_at"] is not None


def test_pending_state_with_for_s():
    eng = SloEngine(SloObjectives(fast_s=60, slow_s=60, for_s=60),
                    registry=MetricsRegistry())
    ok, err = 100, 0
    states = []
    for t in (0, 30, 60, 90, 120, 150):
        eng.observe(_requests_snap(ok, err), now=t)
        states.append({a.rule: a.state
                       for a in eng.alerts()}["availability"])
        ok += 18
        err += 2
    assert PENDING in states and states[-1] == FIRING
    assert states.index(PENDING) < states.index(FIRING)


def test_engine_publishes_closed_label_families():
    reg = MetricsRegistry()
    eng = SloEngine(registry=reg)
    eng.observe({"families": []}, now=0)
    snap = reg.snapshot()
    fams = {f["name"]: f for f in snap["families"]}
    states = fams["cb_alerts_state"]["samples"]
    assert {s["labels"]["rule"] for s in states} == set(RULES)
    assert all(s["value"] == 0 for s in states)
    assert fams["cb_slo_evaluations_total"]["samples"][0]["value"] == 1
    parse_exposition(obs_metrics.render_exposition(snap))


def test_worker_down_rule_against_min_workers():
    eng = SloEngine(SloObjectives(fast_s=60, slow_s=60, min_workers=2,
                                  clear_s=30),
                    registry=MetricsRegistry())
    two_up = {"families": [_gauge_fam(
        "cb_worker_up", ((("worker", "a"),), 1), ((("worker", "b"),), 1))]}
    one_up = {"families": [_gauge_fam(
        "cb_worker_up", ((("worker", "a"),), 1))]}
    for t in (0, 30, 60):
        eng.observe(two_up, now=t)
    assert {a.rule: a.state for a in eng.alerts()}["worker_down"] \
        == INACTIVE
    for t in (90, 120, 150, 180):
        eng.observe(one_up, now=t)
    assert {a.rule: a.state for a in eng.alerts()}["worker_down"] == FIRING


# ---- the same snapshots through both packages' engines ----

BOUNDS = (0.001, 0.01, 0.1, 0.5, 1.0, 5.0)


def seeded_snapshots(n: int, seed: int = SEED):
    """``n`` cumulative registry snapshots 15 s apart, every family a rule
    reads, driven through seeded phases: error bursts, slow reads, hedge
    storms, stalled scrub, fallback plans, tripped breakers, a worker
    down and a counter reset."""
    rng = np.random.default_rng(seed)
    ok = err = fired = prim = verified = fallback = 0
    lat = np.zeros(len(BOUNDS) + 1, dtype=np.int64)
    lag = np.zeros(len(BOUNDS) + 1, dtype=np.int64)
    out = []
    for i in range(n):
        phase = (i // 12) % 6
        ok += int(rng.integers(50, 200))
        err += int(rng.integers(10, 40)) if phase == 1 else \
            int(rng.integers(0, 2))
        slow = phase == 2
        lat += rng.multinomial(int(rng.integers(20, 80)),
                               [0.05, 0.1, 0.1, 0.15, 0.3, 0.2, 0.1]
                               if slow else
                               [0.3, 0.4, 0.25, 0.05, 0, 0, 0])
        lag += rng.multinomial(30, [0.6, 0.3, 0.05, 0.05, 0, 0, 0]
                               if phase != 3 else
                               [0, 0, 0.2, 0.5, 0.3, 0, 0])
        prim += int(rng.integers(100, 300))
        fired += int(rng.integers(20, 40)) if phase == 3 else \
            int(rng.integers(0, 3))
        running = 1 if phase in (0, 4) else 0
        verified += 0 if phase == 4 else int(rng.integers(0, 1 << 20))
        fallback += int(rng.integers(1, 4)) if phase == 5 else 0
        breakers = [int(v) for v in rng.integers(0, 3 if phase == 5 else 1,
                                                 size=5)]
        workers = 1 if phase == 4 else 2
        if i == 50:  # a restart: counters start over
            ok, err = 3, 0
        fams = [
            _requests_snap(ok, err)["families"][0],
            _hist_fam("cb_request_seconds", BOUNDS, lat.tolist(),
                      (("method", "GET"),)),
            _hist_fam("cb_eventloop_lag_seconds", BOUNDS, lag.tolist()),
            _counter_fam("cb_hedges_fired_total", ((), fired)),
            _counter_fam("cb_hedge_primaries_total", ((), prim)),
            _gauge_fam("cb_scrub_running", ((), running)),
            _counter_fam("cb_scrub_bytes_verified_total", ((), verified)),
            _counter_fam("cb_repair_plans_total",
                         ((("kind", "fallback"), ("code", "rs")), fallback),
                         ((("kind", "decode"), ("code", "rs")), i)),
            _gauge_fam("cb_node_breaker_state",
                       *(((("node", f"n{j}"),), v)
                         for j, v in enumerate(breakers))),
            _gauge_fam("cb_worker_up",
                       *(((("worker", f"w{j}"),), 1)
                         for j in range(workers))),
        ]
        out.append((i * 15.0, {"families": fams}))
    return out


def test_engine_equals_jax_on_a_seeded_sequence():
    """Every step of the seeded sequence: equal alert rows (state, since,
    windowed values, threshold, firing count), transitions, history,
    ``to_obj()``, ``stats()`` and the published engine families."""
    from chunky_bits_tpu.obs import metrics as jax_metrics
    from chunky_bits_tpu.obs import slo as jax_slo

    objectives = {"fast_s": 60, "slow_s": 180, "for_s": 30, "clear_s": 45,
                  "read_p99_ms": 300, "scrub_stall_s": 90,
                  "min_workers": 2, "breaker_node_fraction": 0.3,
                  "hedge_fire_ratio": 0.045}
    ours_t, theirs_t = [], []
    ours_reg, theirs_reg = MetricsRegistry(), jax_metrics.MetricsRegistry()
    ours = SloEngine(SloObjectives.from_obj(objectives), registry=ours_reg,
                     on_transition=lambda *a: ours_t.append(a))
    theirs = jax_slo.SloEngine(
        jax_slo.SloObjectives.from_obj(objectives), registry=theirs_reg,
        on_transition=lambda *a: theirs_t.append(a))
    seen = set()
    for now, snap in seeded_snapshots(150):
        ours.observe(snap, now=now)
        theirs.observe(snap, now=now)
        assert [a.to_obj() for a in ours.alerts()] == \
            [a.to_obj() for a in theirs.alerts()], now
        assert ours.to_obj() == theirs.to_obj(), now
        assert ours.stats().to_obj() == theirs.stats().to_obj()
        assert str(ours.stats()) == str(theirs.stats())
        seen.update(a.state for a in ours.alerts())
    assert ours_t == theirs_t
    assert ours.history() == theirs.history()
    # the sequence exercises every state and resolves some alerts
    assert seen == {INACTIVE, PENDING, FIRING}
    fired = {e["rule"] for e in ours.history()}
    assert len(fired) >= 4, fired
    assert any(e["resolved_at"] is not None for e in ours.history())
    assert obs_metrics.render_exposition(ours_reg.snapshot()) == \
        jax_metrics.render_exposition(theirs_reg.snapshot())


# ---- fleet aggregation ----

def _alerts_snap(**rule_states):
    return {"families": [_gauge_fam(
        "cb_alerts_state",
        *(((("rule", rule),), obs_slo._STATE_RANK[state])
          for rule, state in rule_states.items()))]}


def test_fleet_merge_firing_on_one_worker_is_fleet_firing():
    merged = fleet_alert_states([
        ("1001", _alerts_snap(availability=INACTIVE,
                              breaker_open=INACTIVE)),
        ("1002", _alerts_snap(availability=FIRING, breaker_open=PENDING)),
    ])
    assert merged["fleet"]["availability"] == FIRING
    assert merged["fleet"]["breaker_open"] == PENDING
    assert merged["firing"] == ["availability"]
    assert merged["workers"]["1002"]["availability"] == FIRING
    assert merged["workers"]["1001"]["availability"] == INACTIVE


def test_fleet_merge_reaped_worker_contributes_nothing():
    alive = [("1001", _alerts_snap(availability=INACTIVE))]
    dead_too = alive + [("1002", _alerts_snap(availability=FIRING))]
    assert fleet_alert_states(dead_too)["fleet"]["availability"] == FIRING
    merged = fleet_alert_states(alive)
    assert merged["fleet"]["availability"] == INACTIVE
    assert "1002" not in merged["workers"]
    merged = fleet_alert_states([
        ("x", _alerts_snap(**{"not_a_rule": FIRING}))])
    assert set(merged["fleet"]) == set(RULES)
    assert merged["firing"] == []


def test_fleet_merge_equals_jax():
    from chunky_bits_tpu.obs import slo as jax_slo

    rng = np.random.default_rng(SEED + 1)
    states = (INACTIVE, PENDING, FIRING)
    for _ in range(20):
        entries = []
        for w in range(int(rng.integers(0, 5))):
            rules = [r for r in RULES + ("foreign",)
                     if rng.random() < 0.6]
            entries.append((str(1000 + w), _alerts_snap(**{
                r: states[int(rng.integers(0, 3))] for r in rules})))
        assert fleet_alert_states(entries) == \
            jax_slo.fleet_alert_states(entries)


# ---- gateway surfaces ----

def test_gateway_alerts_endpoint_off_by_default(tmp_path, fresh_registry):
    from aiohttp.test_utils import TestClient, TestServer

    from chunky_bits_tpu_torch.gateway import make_app

    async def main():
        cluster = make_cluster(tmp_path)
        async with TestClient(TestServer(make_app(cluster))) as client:
            resp = await client.get("/alerts")
            assert resp.status == 200
            assert await resp.json() == {"enabled": False}
            stats = await (await client.get("/stats")).json()
            assert stats["slo"] == {"enabled": False}
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_gateway_alerts_endpoint_and_build_info(tmp_path, fresh_registry):
    from aiohttp.test_utils import TestClient, TestServer

    from chunky_bits_tpu_torch import __version__
    from chunky_bits_tpu_torch.gateway import make_app

    async def main():
        cluster = make_cluster(tmp_path, slo_eval_s=0.05,
                               slo={"read_p99_ms": 250.0})
        async with TestClient(TestServer(make_app(cluster))) as client:
            assert (await client.put("/obj", data=b"z" * 9000)).status \
                == 200
            await (await client.get("/obj")).read()
            await asyncio.sleep(0.2)
            alerts = await (await client.get("/alerts")).json()
            assert alerts["enabled"] is True
            assert alerts["evaluations"] >= 1
            assert {a["rule"] for a in alerts["alerts"]} == set(RULES)
            assert alerts["objectives"]["read_p99_ms"] == 250.0
            assert alerts["firing"] == []
            stats = await (await client.get("/stats")).json()
            assert stats["slo"]["enabled"] is True
            assert stats["slo"]["evaluations"] >= 1
            parsed = parse_exposition(
                await (await client.get("/metrics")).text())
            for fam in ("cb_alerts_state", "cb_slo_evaluations_total",
                        "cb_build_info"):
                assert fam in parsed, f"missing {fam}"
            rows = [labels for _n, labels, v
                    in parsed["cb_build_info"]["samples"] if v == 1]
            labels = next(r for r in rows if r["slo"] == "on")
            assert labels["version"] == __version__
            assert labels["backend"] == "torch"
            assert labels["sendfile"] in ("on", "off")
            assert labels["code"] in ("rs", "pm-msr")
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_gateway_alerts_fleet_merge_via_spool(tmp_path, fresh_registry):
    """The two-worker supervisor's shape without forking: this worker's
    live engine plus a sibling's spooled snapshot whose
    ``cb_alerts_state`` says firing; with the sibling's file reaped, the
    fleet is not firing."""
    from aiohttp.test_utils import TestClient, TestServer

    from chunky_bits_tpu_torch.gateway import make_app

    spool = tmp_path / "spool"
    spool.mkdir()

    async def main():
        cluster = make_cluster(tmp_path, slo_eval_s=0.05)
        app = make_app(cluster, metrics_spool=str(spool))
        async with TestClient(TestServer(app)) as client:
            sibling = spool / "worker-9999.json"
            obs_metrics.write_snapshot_file(
                str(sibling), _alerts_snap(breaker_open=FIRING))
            await asyncio.sleep(0.15)
            alerts = await (await client.get("/alerts")).json()
            assert alerts["enabled"] is True
            fleet = alerts["fleet"]
            assert fleet["fleet"]["breaker_open"] == FIRING
            assert "breaker_open" in fleet["firing"]
            assert fleet["workers"]["9999"]["breaker_open"] == FIRING
            os.unlink(sibling)
            alerts = await (await client.get("/alerts")).json()
            assert alerts["fleet"]["fleet"]["breaker_open"] == INACTIVE
            assert "9999" not in alerts["fleet"]["workers"]
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_alerts_and_stats_equal_the_jax_gateway(tmp_path):
    """The same raw requests to a JAX gateway (``numpy`` backend) and to
    the port's (``torch``), each with its own Cluster over one tree and
    the engine on (one evaluation, at start): equal ``/alerts`` bodies,
    equal ``slo`` stanzas of ``/stats`` and equal ``cb_alerts_state``
    samples on ``/metrics``."""
    from aiohttp import web

    from chunky_bits_tpu.cluster import Cluster as JaxCluster
    from chunky_bits_tpu.gateway import make_app as jax_make_app
    from chunky_bits_tpu.obs import metrics as jax_metrics
    from chunky_bits_tpu_torch.cluster import Cluster
    from chunky_bits_tpu_torch.gateway import make_app

    tun = {"slo_eval_s": 3600, "slo": {"read_p99_ms": 250,
                                       "fast_s": 30}}

    async def start(app):
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return runner, site._server.sockets[0].getsockname()[1]

    async def get(port, path):
        head = (f"GET {path} HTTP/1.1\r\nHost: x\r\n"
                "Connection: close\r\n\r\n").encode()
        status, _h, body = await raw_request(port, head)
        assert status == 200, path
        return body

    async def main():
        jax_cluster = JaxCluster.from_obj(
            cluster_spec(tmp_path, backend="numpy", **tun))
        port_cluster = Cluster.from_obj(cluster_spec(tmp_path, **tun))
        jax_runner, jax_port = await start(jax_make_app(jax_cluster))
        port_runner, port_port = await start(make_app(port_cluster))
        try:
            data = np.random.default_rng(SEED).integers(
                0, 256, 200_000, dtype=np.uint8).tobytes()
            head = (f"PUT /obj HTTP/1.1\r\nHost: x\r\nConnection: close"
                    f"\r\nContent-Length: {len(data)}\r\n\r\n").encode()
            assert (await raw_request(jax_port, head, data))[0] == 200
            for port in (jax_port, port_port):
                assert await get(port, "/obj") == data
            theirs = json.loads(await get(jax_port, "/alerts"))
            ours = json.loads(await get(port_port, "/alerts"))
            assert ours == theirs
            assert ours["evaluations"] == 1 and ours["enabled"] is True
            theirs = json.loads(await get(jax_port, "/stats"))
            ours = json.loads(await get(port_port, "/stats"))
            assert ours["slo"] == theirs["slo"]
            assert ours["qos"] == theirs["qos"] == {"enabled": False}
            assert sorted(ours) == sorted(theirs)
            fams = [parse_exposition((await get(p, "/metrics")).decode())
                    for p in (jax_port, port_port)]
            assert fams[0]["cb_alerts_state"] == fams[1]["cb_alerts_state"]
        finally:
            await jax_runner.cleanup()
            await port_runner.cleanup()
        await port_cluster.tunables.location_context().aclose()
        await jax_cluster.tunables.location_context().aclose()

    restore = swap_registries(obs_metrics, jax_metrics)
    try:
        arun(main())
    finally:
        restore()


async def raw_request(port, head: bytes, body: bytes = b"") -> tuple:
    """One request over a fresh socket (``Connection: close``); returns
    (status, headers dict with lower-case keys, body)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(head + body)
        await writer.drain()
        data = await reader.read()
    finally:
        writer.close()
        await writer.wait_closed()
    head_raw, _, rest = data.partition(b"\r\n\r\n")
    lines = head_raw.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        key, _, value = line.partition(":")
        headers[key.strip().lower()] = value.strip()
    return int(lines[0].split(" ")[1]), headers, rest


def test_worker_fleet_merges_alerts_through_the_spool(tmp_path):
    """``http-gateway --workers 2`` with ``slo_eval_s`` set: each worker
    runs its engine, and ``/alerts`` through the one port carries the
    fleet merge over the spool with both workers in it; ``stats --json``
    carries the same payload and the summary renders the slo stanza."""
    import re
    import signal
    import subprocess
    import sys
    import threading

    import aiohttp
    import yaml

    from chunky_bits_tpu_torch.cli.stats import stats_command

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = tmp_path / "cluster.yaml"
    spec.write_text(yaml.safe_dump(cluster_spec(tmp_path, slo_eval_s=0.1)))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CHUNKY_BITS_")}
    env["PYTHONPATH"] = repo
    proc = subprocess.Popen(
        [sys.executable, "-m", "chunky_bits_tpu_torch", "--config",
         os.devnull, "http-gateway", str(spec), "-l", "127.0.0.1:0",
         "--workers", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        start_new_session=True)

    async def main(url):
        import time

        async with aiohttp.ClientSession() as session:
            deadline = time.monotonic() + 45
            alerts = {}
            while time.monotonic() < deadline:
                try:
                    async with session.get(f"{url}/alerts") as r:
                        alerts = await r.json()
                    if len(alerts.get("fleet", {}).get("workers", {})) == 2:
                        break
                except aiohttp.ClientError:
                    pass
                await asyncio.sleep(0.3)
            fleet = alerts["fleet"]
            assert len(fleet["workers"]) == 2, alerts
            assert alerts["worker"] in fleet["workers"]
            assert set(fleet["fleet"]) == set(RULES)
            assert fleet["firing"] == [] and alerts["evaluations"] >= 1
            for states in fleet["workers"].values():
                assert set(states) == set(RULES)
        out = io.StringIO()
        assert await stats_command(url, as_json=True, out=out) == 0
        blob = json.loads(out.getvalue())
        assert blob["alerts"]["enabled"] is True
        assert len(blob["alerts"]["fleet"]["workers"]) == 2
        out = io.StringIO()
        assert await stats_command(url, as_json=False, out=out) == 0
        assert "slo: 0 firing" in out.getvalue(), out.getvalue()

    first = {"line": b""}

    def listening_line() -> None:
        line = b""
        while b"listening on" not in line:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
        first["line"] = line

    try:
        # the supervisor's first line, read on a daemon thread under a
        # deadline (the finally below ends the process, and the read)
        reader = threading.Thread(target=listening_line, daemon=True)
        reader.start()
        reader.join(90)
        line = first["line"]
        match = re.search(rb"http://127\.0\.0\.1:(\d+) \(2 workers\)", line)
        assert match, (line, proc.stderr.read() if proc.poll() else b"")
        arun(main(f"http://127.0.0.1:{int(match.group(1))}"), timeout=90)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise
        proc.stdout.close()
        proc.stderr.close()
    assert rc == 0


# ---- profiler stanza + stats CLI ----

def test_profiler_slo_stanza():
    from chunky_bits_tpu_torch.file.profiler import new_profiler

    eng = SloEngine(registry=MetricsRegistry())
    eng.observe({"families": []}, now=0)
    profiler, reporter = new_profiler()
    profiler.attach_slo(eng)
    profiler.attach_slo(eng)
    report = str(reporter.profile())
    assert "Slo<evals=1" in report
    assert report.count("Slo<") == 1


def test_stats_cli_renders_alert_stanza():
    from chunky_bits_tpu_torch.cli.stats import render_summary

    stats = {"worker": "1", "requests": {}, "dropped": {},
             "metrics": {"families": []}}
    out = io.StringIO()
    render_summary(stats, {"status": "ok"}, {"enabled": False}, out)
    assert "slo: disabled" in out.getvalue()
    out = io.StringIO()
    alerts = {
        "enabled": True, "evaluations": 42,
        "firing": ["breaker_open"],
        "fleet": {"firing": ["breaker_open", "scrub_stall"]},
        "alerts": [
            {"rule": "breaker_open", "state": "firing",
             "value_fast": 0.5, "threshold": 0.3, "fired_count": 1},
            {"rule": "availability", "state": "pending",
             "value_fast": 0.02, "threshold": 0.01, "fired_count": 0},
            {"rule": "scrub_stall", "state": "inactive",
             "value_fast": None, "threshold": 1.0, "fired_count": 0},
        ]}
    render_summary(stats, {"status": "ok"}, {"enabled": False}, out,
                   alerts=alerts)
    text = out.getvalue()
    assert "slo: 1 firing (evals=42) fleet-firing=2" in text
    lines = [ln for ln in text.splitlines() if "alert " in ln]
    assert len(lines) == 2, text
    assert "firing" in lines[0] and "breaker_open" in lines[0]
    assert "pending" in lines[1]


def test_stats_cli_watch_loops_and_fetches_alerts(tmp_path, fresh_registry):
    from aiohttp.test_utils import TestServer

    from chunky_bits_tpu_torch.cli.stats import stats_command
    from chunky_bits_tpu_torch.gateway import make_app

    async def main():
        cluster = make_cluster(tmp_path, slo_eval_s=0.05)
        server = TestServer(make_app(cluster))
        await server.start_server()
        try:
            url = f"http://127.0.0.1:{server.port}"
            out = io.StringIO()
            task = asyncio.ensure_future(stats_command(
                url, as_json=False, out=out, watch_s=0.1))
            for _ in range(200):
                await asyncio.sleep(0.05)
                if out.getvalue().count("--- frame") >= 2:
                    break
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass
            text = out.getvalue()
            assert text.count("--- frame") >= 2
            assert "slo:" in text
            out = io.StringIO()
            assert await stats_command(url, as_json=True, out=out) == 0
            blob = json.loads(out.getvalue())
            assert blob["alerts"]["enabled"] is True
        finally:
            await server.close()
        await cluster.tunables.location_context().aclose()

    arun(main())


# ---- tunables serde ----

def test_tunables_slo_serde_and_env(monkeypatch):
    from chunky_bits_tpu.cluster.tunables import Tunables as JaxTunables
    from chunky_bits_tpu_torch.cluster.tunables import (SLO_EVAL_S_ENV,
                                                        Tunables,
                                                        slo_eval_s)
    from chunky_bits_tpu_torch.errors import SerdeError

    t = Tunables.from_obj({"slo_eval_s": 15,
                           "slo": {"breaker_node_fraction": 0.4}})
    assert t.slo_eval_s == 15.0
    assert t.to_obj()["slo"] == {"breaker_node_fraction": 0.4}
    assert Tunables.from_obj(t.to_obj()).slo_eval_s == 15.0
    assert t.to_obj() == JaxTunables.from_obj(
        {"slo_eval_s": 15, "slo": {"breaker_node_fraction": 0.4}}).to_obj()
    assert Tunables.from_obj(None).slo_eval_s == 0.0
    assert "slo_eval_s" not in Tunables.from_obj(None).to_obj()
    with pytest.raises(SerdeError, match="slo_eval_s"):
        Tunables.from_obj({"slo_eval_s": -1})
    with pytest.raises(SerdeError, match="unknown slo objective"):
        Tunables.from_obj({"slo": {"tpyo": 3}})
    monkeypatch.setenv(SLO_EVAL_S_ENV, "30")
    assert slo_eval_s() == 30.0
    assert Tunables.from_obj({}).slo_eval_s == 30.0
    monkeypatch.setenv(SLO_EVAL_S_ENV, "garbage")
    assert slo_eval_s() == 0.0
    # the JAX package's variable never reaches the port
    monkeypatch.delenv(SLO_EVAL_S_ENV)
    monkeypatch.setenv("CHUNKY_BITS_TPU_SLO_EVAL_S", "30")
    assert slo_eval_s() == 0.0
