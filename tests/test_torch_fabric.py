"""The port's fault fabric (``chunky_bits_tpu_torch/sim/fabric.py``) and its
``sim:`` locations, held against the JAX package's.

The same script of verbs, faults and state changes runs on a fabric of each
package, each on its own package's virtual-time loop, and must give the
same outcomes at the same virtual times: the latency draws come from
per-node ``random.Random`` streams seeded from ``(fabric seed, node)``, so
the two sequences are equal float for float (tolerance: none).  ``sim:``
strings parse and serialize as the JAX package's ``Location.parse`` does,
every ``Location`` verb runs against the fabric, and the pm-msr repair
planner takes ``sim:`` replicas as helpers, with the same plan counts and
helper bytes as the JAX package's planner.
"""

import asyncio

import pytest
import torch

from chunky_bits_tpu import sim as jsim
from chunky_bits_tpu.cluster import Cluster as JaxCluster
from chunky_bits_tpu.cluster.scrub import ScrubDaemon as JaxScrubDaemon
from chunky_bits_tpu.errors import LocationError as JaxLocationError
from chunky_bits_tpu.errors import LocationParseError as JaxParseError
from chunky_bits_tpu.file.location import Location as JaxLocation
from chunky_bits_tpu.sim import fabric as jfabric
from chunky_bits_tpu.utils import aio as jaio
from chunky_bits_tpu_torch import sim
from chunky_bits_tpu_torch.cluster import Cluster
from chunky_bits_tpu_torch.cluster.scrub import ScrubDaemon
from chunky_bits_tpu_torch.errors import LocationError, LocationParseError
from chunky_bits_tpu_torch.file.location import Location
from chunky_bits_tpu_torch.sim import fabric
from chunky_bits_tpu_torch.utils import aio
from tests.test_torch_file import bounded
from tests.test_torch_slab import payload_of


@pytest.fixture(autouse=True)
def torch_default(monkeypatch):
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: (package's Location, its fabric module, its sim.run, its errors)
PORT = (Location, fabric, sim.run, LocationError)
JAX = (JaxLocation, jfabric, jsim.run, JaxLocationError)


def both(script):
    """``script(pkg)`` under each package's ``sim.run``; returns both
    results (port first)."""
    return [bounded(lambda pkg=pkg: pkg[2](script(pkg))) for pkg in
            (PORT, JAX)]


# ---- parsing ----

SIM_STRINGS = [
    "sim:fab/n0000/sha256-" + "ab" * 32,
    "sim:fab/n0001",
    "sim:sc-az_outage/n0099/chunk",
    "(0,4096)sim:fab/n0002/c",
    "(17,5)sim:fab/n0002/c",
    "sim:http://x/n0/c",
]


@pytest.mark.parametrize("text", SIM_STRINGS)
def test_parse_and_serialize_equal_jax(text):
    got, ref = Location.parse(text), JaxLocation.parse(text)
    assert got.is_sim() and ref.is_sim()
    assert (got.kind, got.target) == (ref.kind, ref.target)
    assert (got.range.start, got.range.length, got.range.extend_zeros) \
        == (ref.range.start, ref.range.length, ref.range.extend_zeros)
    assert str(got) == str(ref)
    assert Location.parse(str(got)) == got
    assert not (got.is_local() or got.is_slab() or got.is_http())
    assert Location.sim(got.target, got.range) == got


@pytest.mark.parametrize("text", ["sim:", "(1,2)sim:"])
def test_empty_sim_location_refused_like_jax(text):
    with pytest.raises(LocationParseError, match="empty sim location"):
        Location.parse(text)
    with pytest.raises(JaxParseError, match="empty sim location"):
        JaxLocation.parse(text)


def test_hierarchy_of_sim_locations():
    node = Location.parse("sim:fab/n0003")
    child = node.child("sha256-00")
    assert str(child) == "sim:fab/n0003/sha256-00"
    assert child.is_child_of(node) and node.is_parent_of(child)
    ref = JaxLocation.parse("sim:fab/n0003").child("sha256-00")
    assert str(child) == str(ref)


# ---- every verb, against the JAX package ----

def verb_script(pkg):
    loc_cls, fab_mod, _run, err = pkg

    async def main():
        fab = fab_mod.SimFabric("verbs", 3, seed=11)
        out = []

        async def step(label, coro):
            t0 = clock_now()
            try:
                value = await coro
            except err as e:
                value = ("raised", type(e).__name__)
            out.append((label, value, round(clock_now() - t0, 9)))

        try:
            base = loc_cls.parse("sim:verbs/n0001/c0")
            await step("write", base.write(b"0123456789"))
            await step("exists", base.file_exists())
            await step("len", base.file_len())
            await step("read", base.read())
            await step("range", base.with_range(
                type(base.range)(start=3, length=4)).read())
            await step("short range", base.with_range(
                type(base.range)(start=8, length=9)).read())
            await step("zero extend", base.with_range(
                type(base.range)(start=8, length=5, extend_zeros=True))
                .read())

            async def stream():
                reader = await base.reader()
                try:
                    return await reader.read(-1)
                finally:
                    await (aio if pkg is PORT else jaio).close_reader(reader)

            await step("reader", stream())
            await step("read_view", base.read_view())
            node = loc_cls.parse("sim:verbs/n0002")
            reader_cls = (aio if pkg is PORT else jaio).BytesReader
            await step("write_from_reader", node.child("c1")
                       .write_from_reader(reader_cls(b"x" * 777)))
            await step("subfile", _str(node.write_subfile("c2", b"yz")))
            await step("read subfile", node.child("c2").read())
            await step("delete", base.delete())
            await step("exists after", base.file_exists())
            await step("read after", base.read())
            await step("len after", base.file_len())
            await step("negative", base.with_range(
                type(base.range)(start=-1)).read())
            out.append(("stats", fab.stats()))
            out.append(("nodes", [n.stats() for n in fab.nodes.values()]))
        finally:
            fab.close()
        return out

    return main()


def clock_now():
    """The running loop's (virtual) time: each package's seam reads it."""
    return asyncio.get_running_loop().time()


async def _str(coro):
    return str(await coro)


def test_every_verb_equals_jax():
    got, ref = both(verb_script)
    assert got == ref
    outcome = dict((label, value) for label, value, *_ in got
                   if label not in ("stats", "nodes"))
    assert outcome["read"] == b"0123456789"
    assert outcome["range"] == b"3456"
    assert outcome["short range"] == b"89"
    assert outcome["zero extend"] == b"89\0\0\0"
    assert outcome["reader"] == b"0123456789"
    assert outcome["read_view"] is None
    assert outcome["write_from_reader"] == 777
    assert outcome["read subfile"] == b"yz"
    assert outcome["exists after"] is False
    assert outcome["read after"] == ("raised", "LocationError")
    assert outcome["negative"] == ("raised", "LocationError")


# ---- the fault state machine, seeded latency and topology ----

def fault_script(pkg):
    _loc, fab_mod, _run, err = pkg

    async def main():
        fab = fab_mod.SimFabric("faults", 4, zones=("a", "b"), seed=3,
                                latency=fab_mod.LatencyModel(
                                    median_ms=4.0, tail_p=0.3))
        trace = []
        fab.trace_hook = lambda t, event, fields: trace.append(
            (round(t, 9), event, dict(fields)))
        out = []
        node = fab.nodes["n0001"]

        async def op(label, coro):
            t0 = clock_now()
            try:
                value = await coro
            except err as e:
                value = ("raised", type(e).__name__, getattr(e, "status",
                                                             None))
            out.append((label, node.state, value,
                        round(clock_now() - t0, 9)))

        try:
            for i in range(8):
                await op("put", node.write(f"c{i}", bytes([i]) * 4000))
            for state in fab_mod.STATES:
                node.set_state(state)
                await op("get " + state, node.read("c1"))
                await op("head " + state, node.exists("c2"))
            node.faults.put_fail_status = 429
            node.faults.put_fail_remaining = 1
            node.set_state(fab_mod.HEALTHY)
            await op("put one-shot", node.write("c9", b"q"))
            await op("put after", node.write("c9", b"q"))
            node.faults.torn_put_bytes = 5
            node.faults.torn_put_remaining = 1
            await op("torn put", node.write("t", b"abcdefgh"))
            await op("torn read", node.read("t"))
            node.faults.get_delay = 2.5
            await op("delayed get", node.read("c3", 10, 20))
            node.faults.fail_puts = True
            await op("broken disk", node.write("z", b"z"))
            node.set_state(fab_mod.RECOVERING)
            node.recover_s = 12.0
            await asyncio.sleep(13.0)
            await op("lapsed", node.length("c4"))
            out.append(("corrupt", node.corrupt("c5", 7),
                        node.store["c5"][7], node.drop("c6"),
                        node.drop("c6")))
            fab.set_zone_state("b", fab_mod.DEAD)
            out.append(("stats", fab.stats(),
                        [n.stats() for n in fab.nodes.values()],
                        fab.destination_objs(),
                        [n.node_id for n in fab.nodes_in_zone("a")]))
        finally:
            fab.close()
        return out, trace

    return main()


def test_fault_state_machine_equals_jax():
    (got, got_trace), (ref, ref_trace) = both(fault_script)
    assert got == ref
    assert got_trace == ref_trace
    by_label = {row[0]: row for row in got}
    assert by_label["get dead"][2] == ("raised", "LocationError", None)
    assert by_label["get partitioned"][3] >= 5.0
    assert by_label["get erroring"][2] == ("raised", "HttpStatusError", 503)
    assert by_label["put one-shot"][2] == ("raised", "HttpStatusError", 429)
    assert by_label["torn read"][2] == b"abcde"
    assert by_label["delayed get"][3] >= 2.5
    assert by_label["broken disk"][2] == ("raised", "HttpStatusError", 507)
    assert by_label["lapsed"][1] == "healthy"


@pytest.mark.parametrize("seed", [0, 42, 2**31 - 1])
def test_latency_draws_equal_jax(seed):
    model = fabric.LatencyModel(median_ms=3.0, sigma=0.6, tail_p=0.1,
                                tail_mult=40.0)
    jmodel = jfabric.LatencyModel(median_ms=3.0, sigma=0.6, tail_p=0.1,
                                  tail_mult=40.0)
    fab = fabric.SimFabric("draws", 5, seed=seed, latency=model)
    jfab = jfabric.SimFabric("draws", 5, seed=seed, latency=jmodel)
    try:
        for node_id in fab.nodes:
            got = [model.sample(fab.nodes[node_id].rng) for _ in range(200)]
            ref = [jmodel.sample(jfab.nodes[node_id].rng)
                   for _ in range(200)]
            assert got == ref, node_id
            assert min(got) > 0
    finally:
        fab.close()
        jfab.close()


def test_latency_model_bounds_and_errors():
    with pytest.raises(ValueError, match="median_ms"):
        fabric.LatencyModel(median_ms=0)
    model = fabric.LatencyModel(sigma=-1, tail_p=2.0, tail_mult=0.5)
    assert (model.sigma, model.tail_p, model.tail_mult) == (0.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="n_nodes"):
        fabric.SimFabric("none", 0)
    with pytest.raises(ValueError, match="zone"):
        fabric.SimFabric("none", 1, zones=())


def test_reregistering_replaces_and_close_unregisters():
    first = fabric.SimFabric("again", 2)
    second = fabric.SimFabric("again", 3)
    assert fabric.get_fabric("again") is second
    first.close()  # no longer registered under the id: a no-op
    assert fabric.get_fabric("again") is second
    second.close()
    with pytest.raises(LocationError, match="no live sim fabric"):
        fabric.resolve("again/n0000/c")


# ---- the pm-msr repair planner over sim: helpers ----

def msr_script(pkg, payload):
    """A pm-msr d=5 p=4 object on a 9-node fabric; one data chunk dropped;
    one scrub pass with the planner."""
    _loc, fab_mod, _run, _err = pkg
    port = pkg is PORT
    cluster_cls = Cluster if port else JaxCluster
    daemon_cls = ScrubDaemon if port else JaxScrubDaemon
    reader = (aio if port else jaio).BytesReader

    async def main(workdir):
        fab = fab_mod.SimFabric("msr", 9, seed=5)
        cluster = cluster_cls.from_obj({
            "destinations": fab.destination_objs(),
            "metadata": {"type": "path", "format": "yaml",
                         "path": workdir},
            "profiles": {"default": {"data": 5, "parity": 4,
                                     "chunk_size": 14, "code": "pm-msr"}},
            "tunables": {"backend": "torch" if port else "numpy"},
        })
        try:
            await cluster.write_file("obj", reader(payload),
                                     cluster.get_profile())
            ref = await cluster.get_file_ref("obj")
            lost = ref.parts[0].data[1].locations[0]
            assert lost.is_sim()
            node, name = fab_mod.resolve(lost.target)
            assert node.drop(name)
            daemon = daemon_cls(cluster, bytes_per_sec=0, planner=True)
            rep = (await daemon.run_once()).repair
            got = await cluster.file_read_builder(
                await cluster.get_file_ref("obj")).read_all()
            return rep, got, str(lost), name in node.store
        finally:
            await cluster.tunables.location_context().aclose()
            fab.close()

    return main


def test_pm_msr_planner_takes_sim_helpers(tmp_path):
    chunk = 1 << 14
    payload = payload_of(5 * chunk, seed=9)
    outs = []
    for pkg in (PORT, JAX):
        workdir = tmp_path / ("port" if pkg is PORT else "jax")
        workdir.mkdir()
        main = msr_script(pkg, payload)
        outs.append(bounded(lambda: pkg[2](main(str(workdir)))))
    (rep, got, lost, back), (jrep, jgot, jlost, jback) = outs
    assert got == payload and jgot == payload
    assert lost == jlost and back and jback
    assert rep["plans_msr"] == 1 and rep["plans_decode"] == 0, rep
    assert rep["helper_bytes_msr"] == 2 * chunk
    assert rep["by_code"]["pm-msr"]["plans_msr"] == 1
    for key in ("plans_msr", "plans_decode", "plans_copy", "plans_fallback",
                "helper_bytes_msr", "helper_bytes_decode", "bytes_rebuilt"):
        assert rep[key] == jrep[key], key
