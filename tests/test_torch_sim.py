"""The port's simulator (``chunky_bits_tpu_torch/sim``) against the JAX
package's ``chunky_bits_tpu/sim``: the mirror of ``tests/test_sim.py`` plus
cross-package checks.

Three layers, as in the reference's file: the clock seam and the virtual
loop (and the production import closure, which must load nothing of
``sim/``); the fault-injection fabric and the ``sim:`` location surface;
and the scenario engine, where every library scenario passes its own
invariant verdicts at N=12 and the same seed gives a byte-identical event
trace and an equal metrics snapshot.

Across the packages: the same scenario, seed and workdir path run through
the JAX package on its default CPU codec and through the port on ``torch``
and on ``numpy`` must give equal trace bytes, verdicts, virtual seconds and
SLO reports (tolerance: none).  Scenario clusters name no backend, so the
port's runs here set ``CHUNKY_BITS_TORCH_BACKEND``; each run is bounded by
``tests/test_torch_file.py::bounded``.
"""

import asyncio
import json
import os
import subprocess
import sys

import pytest
import torch

from chunky_bits_tpu.sim import scenario as jscenario
from chunky_bits_tpu_torch.errors import (HttpStatusError, LocationError,
                                          LocationParseError)
from chunky_bits_tpu_torch.sim import fabric as fabric_mod
from chunky_bits_tpu_torch.sim import run as sim_run
from chunky_bits_tpu_torch.sim.scenario import (SCENARIOS, fresh_workdir,
                                                run_scenario)
from chunky_bits_tpu_torch.utils import clock as clock_mod
from tests.test_torch_file import bounded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds one scenario run may take on this box before the test fails
SCENARIO_TIMEOUT = 120


@pytest.fixture(autouse=True)
def torch_default(monkeypatch):
    """Scenario clusters name no backend: on the CPU the default must be a
    host backend (the port's own default is the card).  One intra-op
    thread: a scenario makes thousands of tiny applies, and torch's
    spinning worker threads would otherwise starve the other test
    processes."""
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scenario(name, **kwargs):
    return bounded(lambda: run_scenario(name, **kwargs), SCENARIO_TIMEOUT)


def sim(coro):
    return bounded(lambda: sim_run(coro))


# ---- clock seam + virtual loop ----

def test_virtual_loop_compresses_time():
    """An hour and a half of virtual sleeping costs little wall time, and
    the seam's monotonic() agrees with the loop's timebase."""
    real = clock_mod.system_clock()

    async def main():
        t0 = clock_mod.monotonic()
        await clock_mod.sleep(3600.0)
        await asyncio.sleep(1800.0)
        return clock_mod.monotonic() - t0

    wall0 = real.monotonic()
    virtual = sim(main())
    assert virtual >= 5400.0
    assert real.monotonic() - wall0 < 10.0


def test_clock_seam_restored_after_run():
    assert clock_mod.active() is clock_mod.system_clock()

    async def boom():
        await clock_mod.sleep(60.0)
        raise RuntimeError("scenario failed")

    with pytest.raises(RuntimeError, match="scenario failed"):
        sim(boom())
    assert clock_mod.active() is clock_mod.system_clock()


def test_thread_work_completes_at_zero_virtual_width(tmp_path):
    path = tmp_path / "payload.bin"

    async def main():
        t0 = clock_mod.monotonic()
        await asyncio.to_thread(path.write_bytes, b"x" * 65536)
        data = await asyncio.to_thread(path.read_bytes)
        return data, clock_mod.monotonic() - t0

    data, virtual_width = sim(main())
    assert data == b"x" * 65536
    assert virtual_width == 0.0


def test_sim_run_rejects_nested_loop():
    async def outer():
        coro = asyncio.sleep(0)
        try:
            sim_run(coro)
        finally:
            coro.close()

    with pytest.raises(RuntimeError, match="running event loop"):
        bounded(lambda: asyncio.run(outer()))


def test_production_imports_nothing_from_sim():
    """In a clean interpreter the cluster, file, scrub, repair and gateway
    planes of the port import with no ``sim`` module loaded (the ``sim:``
    location branches import the fabric lazily), and nothing of the JAX
    package or of jax."""
    code = (
        "import sys\n"
        "import chunky_bits_tpu_torch.cluster\n"
        "import chunky_bits_tpu_torch.file.location\n"
        "import chunky_bits_tpu_torch.cluster.scrub\n"
        "import chunky_bits_tpu_torch.cluster.repair\n"
        "import chunky_bits_tpu_torch.gateway\n"
        "bad = [m for m in sys.modules"
        " if m.startswith('chunky_bits_tpu_torch.sim')"
        " or m.startswith('chunky_bits_tpu.') or m == 'chunky_bits_tpu'"
        " or m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, f'production imports pulled in {bad}'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)


def test_sim_modules_import_nothing_of_jax():
    """The port's simulator keeps its own copies: loading all of it pulls
    in nothing of the JAX package."""
    code = (
        "import sys\n"
        "import chunky_bits_tpu_torch.sim.fabric\n"
        "import chunky_bits_tpu_torch.sim.scenario\n"
        "import chunky_bits_tpu_torch.sim.crash\n"
        "bad = [m for m in sys.modules"
        " if m.startswith('chunky_bits_tpu.') or m == 'chunky_bits_tpu'"
        " or m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, f'sim imports pulled in {bad}'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)


# ---- fault-injection fabric ----

def test_fabric_state_machine_semantics():
    async def main():
        fab = fabric_mod.SimFabric("sm", 1, seed=5)
        node = fab.nodes["n0000"]
        await node.write("c", b"payload")

        with pytest.raises(ValueError, match="unknown node state"):
            node.set_state("zombie")

        node.set_state(fabric_mod.DEAD)
        with pytest.raises(LocationError, match="dead"):
            await node.read("c")

        node.set_state(fabric_mod.PARTITIONED)
        node.partition_stall_s = 7.5
        t0 = clock_mod.monotonic()
        with pytest.raises(LocationError, match="partitioned"):
            await node.read("c")
        assert clock_mod.monotonic() - t0 >= 7.5

        node.set_state(fabric_mod.ERRORING)
        with pytest.raises(HttpStatusError):
            await node.read("c")

        node.set_state(fabric_mod.RECOVERING)
        node.recover_s = 30.0
        assert await node.read("c") == b"payload"
        assert node.state == fabric_mod.RECOVERING
        await clock_mod.sleep(31.0)
        assert await node.read("c") == b"payload"
        assert node.state == fabric_mod.HEALTHY
        fab.close()

    sim(main())


def test_fabric_latency_is_seeded_deterministic():
    model = fabric_mod.LatencyModel(median_ms=3.0, tail_p=0.2)
    fab_a = fabric_mod.SimFabric("la", 3, seed=42, latency=model)
    fab_b = fabric_mod.SimFabric("lb", 3, seed=42, latency=model)
    try:
        for node_id in fab_a.nodes:
            a = [model.sample(fab_a.nodes[node_id].rng) for _ in range(64)]
            b = [model.sample(fab_b.nodes[node_id].rng) for _ in range(64)]
            assert a == b
        first = [model.sample(fabric_mod.SimFabric(
            "lc", 2, seed=42, latency=model).nodes["n0000"].rng)
            for _ in range(16)]
        second = [model.sample(fabric_mod.SimFabric(
            "ld", 2, seed=42, latency=model).nodes["n0001"].rng)
            for _ in range(16)]
        assert first != second
    finally:
        for fid in ("la", "lb", "lc", "ld"):
            fabric_mod._FABRICS.pop(fid, None)


def test_fault_injector_one_shot_and_broken_disk():
    inj = fabric_mod.FaultInjector()
    inj.put_fail_status = 503
    inj.put_fail_remaining = 2
    assert inj.put_fault() == 503
    assert inj.put_fault() == 503
    assert inj.put_fault() == 0
    inj.fail_puts = True
    assert inj.put_fault() == 507
    inj.fail_puts = False
    assert inj.get_fault() == 0.0
    inj.get_delay = 0.25
    assert inj.get_fault() == 0.25


def test_sim_location_surface():
    from chunky_bits_tpu_torch.file.location import Location, Range

    loc = Location.parse("sim:fabX/n0000/chunk0")
    assert loc.is_sim() and str(loc) == "sim:fabX/n0000/chunk0"
    with pytest.raises(LocationParseError):
        Location.parse("sim:")
    with pytest.raises(LocationError, match="no live sim fabric"):
        fabric_mod.resolve("ghost/n0000/c")
    with pytest.raises(LocationError, match="does not name"):
        fabric_mod.resolve("only-two/parts")

    async def main():
        fab = fabric_mod.SimFabric("fabX", 2, seed=0)
        try:
            with pytest.raises(LocationError, match="no node"):
                fabric_mod.resolve("fabX/n9999/c")
            await loc.write(b"0123456789")
            assert await loc.file_exists()
            assert await loc.file_len() == 10
            assert await loc.read() == b"0123456789"
            ranged = loc.with_range(Range(start=2, length=5))
            assert await ranged.read() == b"23456"
            await loc.delete()
            assert not await loc.file_exists()
            with pytest.raises(LocationError, match="no chunk"):
                await loc.read()
        finally:
            fab.close()

    sim(main())


def test_fabric_zone_topology_and_stats():
    fab = fabric_mod.SimFabric("zt", 9, zones=("a", "b", "c"), seed=1)
    try:
        assert {n.zone for n in fab.nodes.values()} == {"a", "b", "c"}
        assert len(fab.nodes_in_zone("a")) == 3
        fab.set_zone_state("b", fabric_mod.DEAD)
        assert all(n.state == fabric_mod.DEAD
                   for n in fab.nodes_in_zone("b"))
        stats = fab.stats()
        assert stats["nodes"] == 9
        assert stats["by_state"] == {"dead": 3, "healthy": 6}
        with pytest.raises(ValueError, match="no nodes in zone"):
            fab.set_zone_state("nowhere", fabric_mod.DEAD)
        dests = fab.destination_objs()
        assert len(dests) == 9
        assert dests[0]["location"].startswith("sim:zt/")
        assert dests[0]["zones"] == ["a"]
    finally:
        fab.close()
    with pytest.raises(LocationError, match="no live sim fabric"):
        fabric_mod.get_fabric("zt")


# ---- scenario engine ----

#: per-scenario verdicts that must appear and hold (the reference's
#: ``tests/test_sim.py::_KEY_VERDICTS``)
_KEY_VERDICTS = {
    "az_outage": ("converged", "no_fallback_storm",
                  "reads_clean_outside_fault",
                  "slo_detected_breaker_open", "slo_no_false_positives"),
    "rolling_restart": ("converged", "reads_clean_outside_fault",
                        "slo_no_false_positives"),
    "pm_msr_restart_repair": ("converged", "repair_labeled_pm_msr",
                              "slo_no_false_positives"),
    "thundering_herd": ("hedge_within_budget", "herd_reads_served",
                        "slo_detected_hedge_exhaustion",
                        "slo_no_false_positives"),
    "correlated_failures": ("converged", "replaced_lost_chunks",
                            "slo_detected_repair_fallback_storm",
                            "slo_no_false_positives"),
    "flapping_node": ("breaker_recovered", "traffic_returned",
                      "slo_no_false_positives"),
    "slow_leak": ("converged", "corruption_detected",
                  "slo_no_false_positives"),
    "noisy_neighbor": ("victim_isolated_under_drr",
                       "victim_near_baseline_under_drr",
                       "fifo_leg_degraded", "slo_no_false_positives"),
    "disk_corruption_storm": ("converged", "corruption_detected",
                              "torn_writes_ridden_out",
                              "disk_full_ridden_out",
                              "reads_clean_outside_fault",
                              "slo_no_false_positives"),
    "fleet_partition": ("converged", "slo_detected_scrub_stall",
                        "slo_detected_breaker_open",
                        "slo_detected_repair_fallback_storm",
                        "slo_no_false_positives"),
}


def test_library_matches_reference():
    """The same ten scenarios, with the same geometry overrides and SLO
    specs, as the JAX package's library."""
    assert sorted(SCENARIOS) == sorted(jscenario.SCENARIOS)
    assert sorted(SCENARIOS) == sorted(_KEY_VERDICTS)
    for name, sc in SCENARIOS.items():
        ref = jscenario.SCENARIOS[name]
        assert (sc.env, sc.slo) == (ref.env, ref.slo), name


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_invariants(name, tmp_path):
    """Every library scenario passes all its verdicts at N=12."""
    result = scenario(name, nodes=12, seed=0, workdir=str(tmp_path),
                      objects=6)
    assert result.ok(), (
        f"{name} failed verdicts "
        f"{ {k: v for k, v in result.verdicts.items() if not v} }\n"
        + result.trace.decode()[-2000:])
    for verdict in _KEY_VERDICTS[name]:
        assert result.verdicts.get(verdict) is True, (name, verdict)
    if result.virtual_seconds >= 60.0:
        assert result.compression() > 10.0, result.to_obj()


def test_scenario_same_seed_byte_identical(tmp_path):
    workdir = str(tmp_path / "det")
    runs = []
    for _ in range(2):
        fresh_workdir(workdir)
        runs.append(scenario("az_outage", nodes=10, seed=7,
                             workdir=workdir, objects=6))
    a, b = runs
    assert a.trace == b.trace, "event traces diverged across runs"
    assert a.metrics == b.metrics, "metrics snapshots diverged"
    assert a.virtual_seconds == b.virtual_seconds
    assert a.verdicts == b.verdicts
    assert a.trace.count(b"\n") > 20


def test_scenario_different_seed_diverges(tmp_path):
    workdir = str(tmp_path / "ctl")
    fresh_workdir(workdir)
    a = scenario("az_outage", nodes=10, seed=7, workdir=workdir, objects=6)
    fresh_workdir(workdir)
    b = scenario("az_outage", nodes=10, seed=8, workdir=workdir, objects=6)
    assert a.trace != b.trace
    assert a.ok() and b.ok()


def test_scenario_result_shape(tmp_path):
    workdir = fresh_workdir(str(tmp_path / "row"))
    result = scenario("rolling_restart", nodes=10, seed=3, workdir=workdir,
                      objects=6)
    row = json.loads(json.dumps(result.to_obj()))
    for key in ("name", "seed", "nodes", "virtual_s", "wall_s",
                "compression_x", "ok", "verdicts", "trace_events"):
        assert key in row, f"missing {key} in {sorted(row)}"
    assert row["ok"] is True
    assert row["trace_events"] > 0


def test_unknown_scenario_fails_loudly(tmp_path):
    with pytest.raises(ValueError, match="unknown scenario"):
        run_scenario("heat_death", workdir=str(tmp_path))


def test_every_scenario_reports_slo_verdicts(tmp_path):
    result = scenario("fleet_partition", nodes=12, seed=0,
                      workdir=str(tmp_path), objects=6)
    assert "slo_no_false_positives" in result.verdicts
    spec = SCENARIOS["fleet_partition"].slo
    for rule in spec["expected"]:
        assert f"slo_detected_{rule}" in result.verdicts
    report = result.details["slo"]
    assert report["false_positives"] == 0
    for rule, cfg in spec["expected"].items():
        assert 0.0 < report["detect_latency_s"][rule] <= cfg["within_s"]
    assert result.trace.count(b'"event":"alert"') == report["transitions"]


def test_detection_latency_is_deterministic(tmp_path):
    runs = []
    workdir = str(tmp_path / "det")
    for _ in range(2):
        fresh_workdir(workdir)
        runs.append(scenario("thundering_herd", nodes=12, seed=0,
                             workdir=workdir, objects=6))
    a, b = runs
    assert a.details["slo"] == b.details["slo"]
    assert a.details["slo"]["detect_latency_s"], "expected a detection"
    assert a.trace == b.trace


# ---- the port against the JAX package ----

def first_difference(a: bytes, b: bytes) -> str:
    for i, (x, y) in enumerate(zip(a.decode().splitlines(),
                                   b.decode().splitlines())):
        if x != y:
            return f"line {i}:\n jax:  {x}\n port: {y}"
    return f"{len(a)} and {len(b)} bytes, one a prefix of the other"


@pytest.mark.parametrize("name,nodes,seed", [
    ("az_outage", 10, 7),
    ("az_outage", 10, 8),
    ("thundering_herd", 12, 0),
    ("pm_msr_restart_repair", 12, 0),
])
def test_trace_equals_reference(name, nodes, seed, tmp_path, monkeypatch):
    """The JAX package (its default CPU codec) and the port on ``torch``
    and on ``numpy``, in one workdir path, give equal trace bytes,
    verdicts, virtual seconds and SLO reports."""
    workdir = str(tmp_path / "same")
    fresh_workdir(workdir)
    ref = bounded(lambda: jscenario.run_scenario(
        name, nodes=nodes, seed=seed, workdir=workdir, objects=6),
        SCENARIO_TIMEOUT)
    assert ref.ok()
    for backend in ("torch", "numpy"):
        monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", backend)
        fresh_workdir(workdir)
        got = scenario(name, nodes=nodes, seed=seed, workdir=workdir,
                       objects=6)
        assert got.trace == ref.trace, (backend, first_difference(
            ref.trace, got.trace))
        assert got.verdicts == ref.verdicts, backend
        assert got.virtual_seconds == ref.virtual_seconds, backend
        assert got.details["slo"] == ref.details["slo"], backend
        assert got.details["fabric"] == ref.details["fabric"], backend
        assert got.details["client_reads"] == ref.details["client_reads"]


def test_thousand_node_az_outage_equals_reference(tmp_path):
    """The README's thousand-node run: the port's trace, verdicts and SLO
    report equal the JAX package's.  Both fail the same one verdict at
    this size: the breaker-open detection bound of 1500 s was tuned at
    N=100, and at N=1000 a partitioned node meets too few requests a pass
    to trip its breaker in time (``chip_smoke.py``'s ``SIM_BIG_FALSE``)."""
    workdir = str(tmp_path / "big")
    fresh_workdir(workdir)
    ref = bounded(lambda: jscenario.run_scenario(
        "az_outage", nodes=1000, seed=0, workdir=workdir), SCENARIO_TIMEOUT)
    fresh_workdir(workdir)
    got = scenario("az_outage", nodes=1000, seed=0, workdir=workdir)
    assert got.trace == ref.trace, first_difference(ref.trace, got.trace)
    assert got.verdicts == ref.verdicts
    assert got.details["slo"] == ref.details["slo"]
    assert {k for k, v in got.verdicts.items() if not v} \
        == {"slo_detected_breaker_open"}
