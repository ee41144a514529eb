"""Seeded chaos soaks against the port (``chunky_bits_tpu_torch``): the
mirror of ``tests/test_chaos.py``.

Random write, overwrite, read, corrupt, delete, verify and resilver
sequences against a live cluster of the port, asserting after every step
that reads stay byte-identical with at most p chunks damaged per part,
that resilver returns an object to Valid, and that listing reflects every
object written; over path, packed slab and HTTP destinations, under a
concurrently running scrub daemon, with one slab destination out of
space, and against a straggler on the simulator's fabric
(``sim:`` locations) with hedging off and on.

The soaks run on the port's virtual-time loop (``sim.run``).  The
real-clock straggler soak keeps the reference's ``slow`` marker.
Clusters name no backend, so the CPU runs set
``CHUNKY_BITS_TORCH_BACKEND=torch``; every run is bounded by
``tests/test_torch_file.py::bounded``.
"""

import asyncio
import os
import pathlib

import numpy as np
import pytest
import torch

from chunky_bits_tpu_torch.cluster import Cluster
from chunky_bits_tpu_torch.file import FileIntegrity
from chunky_bits_tpu_torch.sim import run as sim_run
from chunky_bits_tpu_torch.utils import aio
from tests.test_torch_file import bounded


@pytest.fixture(autouse=True)
def torch_default():
    """The clusters name no backend: on the CPU the default is ``torch``,
    with one intra-op thread (tiny applies; spinning workers would starve
    the other test processes).  A patch of its own, so a test's
    ``monkeypatch.undo()`` keeps it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
        yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [1, 7])
def test_chaos_soak(tmp_path, seed):
    rng = np.random.default_rng(seed)
    root = tmp_path / f"s{seed}"
    dirs = []
    for i in range(6):
        d = root / f"disk{i}"
        d.mkdir(parents=True)
        dirs.append(str(d))
    meta = root / "meta"
    meta.mkdir()

    # built inside main(): every time-sensitive object (scoreboard,
    # retry backoff) must be born under the virtual clock sim.run
    # installs, not capture real timestamps before it
    cluster: Cluster = None  # type: ignore[assignment]

    contents: dict[str, bytes] = {}
    # chunks we have damaged since the last resilver, per object:
    # {name: set of (part_idx, chunk_idx)} — never exceeds p per part
    damaged: dict[str, set] = {}

    def chunk_path(part_obj, ci):
        chunks = part_obj["data"] + part_obj["parity"]
        t = chunks[ci]["locations"][0]
        return t[len("file://"):] if t.startswith("file://") else t

    async def read_meta(name):
        # through the store surface, not the raw path layout — the
        # meta-log CI leg rebuilds plain path stores fleet-wide
        return await cluster.metadata.read(name)

    async def op_write(name):
        size = int(rng.integers(1, 60000))
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        await cluster.write_file(name, aio.BytesReader(payload),
                                 cluster.get_profile())
        contents[name] = payload
        damaged[name] = set()

    async def op_read(name):
        got = await (await cluster.get_file_ref(name)) \
            .read_builder().read_all()
        assert got == contents[name], f"read mismatch for {name}"

    async def op_damage(name, corrupt):
        obj = await read_meta(name)
        part_idx = int(rng.integers(0, len(obj["parts"])))
        part_obj = obj["parts"][part_idx]
        n_chunks = len(part_obj["data"]) + len(part_obj["parity"])
        hurt_here = {c for (p_, c) in damaged[name] if p_ == part_idx}
        if len(hurt_here) >= 2:  # p == 2: stay reconstructible
            return
        choices = [c for c in range(n_chunks) if c not in hurt_here]
        ci = int(rng.choice(choices))
        path = chunk_path(part_obj, ci)
        if not os.path.exists(path):
            return  # shared content-addressed chunk already damaged
        if corrupt:
            raw = bytearray(pathlib.Path(path).read_bytes())
            raw[int(rng.integers(0, len(raw)))] ^= 0x01
            pathlib.Path(path).write_bytes(bytes(raw))
        else:
            os.remove(path)
        damaged[name].add((part_idx, ci))

    async def op_verify(name):
        report = await (await cluster.get_file_ref(name)).verify()
        if damaged[name]:
            assert report.integrity() != FileIntegrity.VALID, \
                f"damage to {name} not detected"
        else:
            assert report.integrity() == FileIntegrity.VALID

    async def op_resilver(name):
        ref = await cluster.get_file_ref(name)
        await ref.resilver(cluster.get_destination(cluster.get_profile()))
        await cluster.write_file_ref(name, ref)
        damaged[name] = set()
        report = await (await cluster.get_file_ref(name)).verify()
        assert report.integrity() == FileIntegrity.VALID
        await op_read(name)

    async def main():
        nonlocal cluster
        cluster = Cluster.from_obj({
            "destinations": [{"location": x} for x in dirs],
            "metadata": {"type": "path", "format": "yaml",
                         "path": str(meta)},
            "profiles": {"default": {"data": 3, "parity": 2,
                                     "chunk_size": 12}},
        })
        await op_write("obj0")
        for step in range(40):
            names = list(contents)
            name = names[int(rng.integers(0, len(names)))]
            op = rng.choice(
                ["write", "overwrite", "read", "corrupt", "delete",
                 "verify", "resilver"])
            if op == "write":
                await op_write(f"obj{len(contents)}")
            elif op == "overwrite":
                await op_write(name)
            elif op == "read":
                await op_read(name)
            elif op == "corrupt":
                await op_damage(name, corrupt=True)
                await op_read(name)
            elif op == "delete":
                await op_damage(name, corrupt=False)
                await op_read(name)
            elif op == "verify":
                await op_verify(name)
            elif op == "resilver":
                await op_resilver(name)
        # final sweep: repair everything, then everything is Valid
        for name in contents:
            await op_resilver(name)
        listed = await cluster.list_files("")
        listed_names = {str(x) for x in listed}
        for name in contents:
            assert any(name in x for x in listed_names), \
                f"{name} missing from listing {listed_names}"

    bounded(lambda: sim_run(main()))


@pytest.mark.slow
def test_chaos_slow_location_hedged(tmp_path):
    """THE real-clock canary (slow-marked, excluded from tier-1):
    straggler chaos over real sockets with real stalls, asserting
    wall-clock hedge latency — the one soak that would catch a
    regression in the REAL timer path that the virtual-time
    conversions cannot see.

    Every chunk has two replicas and one node serves with a 500 ms
    stall.  A hedged read (`tunables.hedge_ms`) must complete near the
    FAST replica's latency — far under one stall — and bytes must be
    identical whichever location wins the race: slow-node-primary
    (replica wins), fast-primary (primary wins), and hedging-off (the
    stall is simply paid) must all agree."""
    import time

    from chunky_bits_tpu_torch.file.location import Location
    from tests.http_node import FakeHttpNode

    rng = np.random.default_rng(11)
    meta = tmp_path / "meta"
    meta.mkdir()
    payload = rng.integers(0, 256, 150000, dtype=np.uint8).tobytes()

    async def main():
        nodes = [await FakeHttpNode().start() for _ in range(5)]
        try:
            def make_cluster(hedge_ms):
                return Cluster.from_obj({
                    "destinations": [{"location": n.url + "/"}
                                     for n in nodes],
                    "metadata": {"type": "path", "format": "yaml",
                                 "path": str(meta)},
                    "profiles": {"default": {"data": 3, "parity": 2,
                                             "chunk_size": 14}},
                    "tunables": {"hedge_ms": hedge_ms},
                })

            writer = make_cluster(0)
            await writer.write_file("obj", aio.BytesReader(payload),
                                    writer.get_profile())
            ref = await writer.get_file_ref("obj")
            # replicate every chunk onto a second node, never node 0:
            # node 0 is the one slow replica of the scenario
            pick = 1
            for part in ref.parts:
                for chunk in part.data + part.parity:
                    key = str(chunk.hash)
                    owner = next(n for n in nodes
                                 if str(chunk.locations[0])
                                 .startswith(n.url))
                    while nodes[pick] is owner or pick == 0:
                        pick = (pick + 1) % len(nodes)
                    nodes[pick].store[key] = owner.store[key]
                    chunk.locations.append(
                        Location.http(f"{nodes[pick].url}/{key}"))
                    pick = (pick + 1) % len(nodes)
            await writer.write_file_ref("obj", ref)

            async def read_all(cluster):
                r = await cluster.get_file_ref("obj")
                return await cluster.file_read_builder(r).read_all()

            # hedging OFF pays the stall but stays byte-identical
            nodes[0].get_delay = 0.5
            cold = make_cluster(0)
            t0 = time.monotonic()
            assert await read_all(cold) == payload
            off_elapsed = time.monotonic() - t0
            assert off_elapsed >= 0.5, \
                "expected the unhedged read to pay the stall"

            # hedging ON completes near the fast replica's latency:
            # every stalled primary is raced after ~25 ms
            hedged = make_cluster(25)
            t0 = time.monotonic()
            assert await read_all(hedged) == payload
            on_elapsed = time.monotonic() - t0
            assert on_elapsed < 0.5, (
                f"hedged read took {on_elapsed:.3f}s — it waited out "
                f"the 0.5s stall instead of racing the fast replica")
            # repeat reads ride the scoreboard's ordering (slow node
            # demoted) and stay identical
            assert await read_all(hedged) == payload

            # flip the slow side: now the REPLICA side added above is
            # never slow, node 0 is fast again and a different node
            # stalls — whichever location wins, bytes are identical
            nodes[0].get_delay = 0.0
            nodes[2].get_delay = 0.35
            flipped = make_cluster(25)
            assert await read_all(flipped) == payload
            stats = hedged.health_scoreboard().stats()
            assert stats.hedges_fired >= 1, \
                f"no hedges fired against a stalling node: {stats}"
            for cluster in (cold, hedged, flipped, writer):
                await cluster.tunables.location_context().aclose()
        finally:
            for n in nodes:
                await n.stop()

    bounded(lambda: asyncio.run(main()))


def test_chaos_slow_location_hedged_virtual(tmp_path):
    """The straggler scenario in compressed virtual time (the tier-1
    face of the slow canary above): simulated nodes, one slowed by the
    fabric's fault state machine, durations measured on the virtual
    clock.  Hedging-off pays the straggler's latency; hedging-on
    completes near the fast replica's latency; bytes are identical
    either way."""
    from chunky_bits_tpu_torch.file.location import Location
    from chunky_bits_tpu_torch.sim import fabric as fabric_mod
    from chunky_bits_tpu_torch.utils import clock as clock_mod

    rng = np.random.default_rng(11)
    meta = tmp_path / "meta"
    meta.mkdir()
    payload = rng.integers(0, 256, 150000, dtype=np.uint8).tobytes()

    async def main():
        fab = fabric_mod.SimFabric("hedge", 5, zones=("z",), seed=11)
        try:
            def make_cluster(hedge_ms):
                return Cluster.from_obj({
                    "destinations": fab.destination_objs(),
                    "metadata": {"type": "path", "format": "yaml",
                                 "path": str(meta)},
                    "profiles": {"default": {"data": 3, "parity": 2,
                                             "chunk_size": 14}},
                    "tunables": {"hedge_ms": hedge_ms},
                })

            writer = make_cluster(0)
            await writer.write_file("obj", aio.BytesReader(payload),
                                    writer.get_profile())
            ref = await writer.get_file_ref("obj")
            # replicate every chunk onto a second node, never n0000:
            # n0000 is the one slow replica of the scenario
            nodes = [fab.nodes[k] for k in sorted(fab.nodes)]
            pick = 1
            for part in ref.parts:
                for chunk in part.data + part.parity:
                    owner, key = fabric_mod.resolve(
                        chunk.locations[0].target)
                    while nodes[pick] is owner or pick == 0:
                        pick = (pick + 1) % len(nodes)
                    replica = nodes[pick]
                    replica.store[key] = owner.store[key]
                    chunk.locations.append(Location.sim(
                        f"{fab.fabric_id}/{replica.node_id}/{key}"))
                    pick = (pick + 1) % len(nodes)
            await writer.write_file_ref("obj", ref)

            async def read_all(cluster):
                r = await cluster.get_file_ref("obj")
                return await cluster.file_read_builder(r).read_all()

            # n0000 straggles: ~0.5 s of VIRTUAL latency per request
            # (median 2 ms x 250), the state machine's slow mode
            slow = fab.nodes["n0000"]
            slow.slow_factor = 250.0
            slow.set_state(fabric_mod.SLOW)

            # hedging OFF pays the straggler but stays byte-identical
            cold = make_cluster(0)
            t0 = clock_mod.monotonic()
            assert await read_all(cold) == payload
            off_elapsed = clock_mod.monotonic() - t0
            assert off_elapsed >= 0.2, (
                f"unhedged read took {off_elapsed:.3f}s virtual — "
                "never met the straggler?")

            # hedging ON completes near the fast replica's latency
            hedged = make_cluster(25)
            t0 = clock_mod.monotonic()
            assert await read_all(hedged) == payload
            on_elapsed = clock_mod.monotonic() - t0
            assert on_elapsed < 0.2, (
                f"hedged read took {on_elapsed:.3f}s virtual — it "
                "waited out the straggler instead of racing the "
                "fast replica")
            assert await read_all(hedged) == payload
            stats = hedged.health_scoreboard().stats()
            assert stats.hedges_fired >= 1, \
                f"no hedges fired against a straggler: {stats}"
            for cluster in (cold, hedged, writer):
                await cluster.tunables.location_context().aclose()
        finally:
            fab.close()

    bounded(lambda: sim_run(main()))


def test_chaos_slab_store_churn(tmp_path):
    """The soak invariants over PACKED destinations (file/slab.py):
    random write/overwrite/read/corrupt/delete/verify/resilver churn
    with mid-churn compaction of every store.  Damage flips bytes
    inside live slab extents or marks them dead — never more than p
    per part — and reads must stay byte-identical throughout."""
    from chunky_bits_tpu_torch.file import slab

    rng = np.random.default_rng(13)
    root = tmp_path / "slabs"
    dirs = []
    for i in range(6):
        d = root / f"disk{i}"
        d.mkdir(parents=True)
        dirs.append(str(d))
    meta = root / "meta"
    meta.mkdir()
    cluster = Cluster.from_obj({
        "destinations": [{"location": f"slab:{x}"} for x in dirs],
        "metadata": {"type": "path", "format": "yaml", "path": str(meta)},
        "profiles": {"default": {"data": 3, "parity": 2,
                                 "chunk_size": 12}},
    })

    contents: dict[str, bytes] = {}
    damaged: dict[str, set] = {}

    async def op_write(name):
        size = int(rng.integers(1, 50000))
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        await cluster.write_file(name, aio.BytesReader(payload),
                                 cluster.get_profile())
        contents[name] = payload
        damaged[name] = set()

    async def op_read(name):
        got = await cluster.file_read_builder(
            await cluster.get_file_ref(name)).read_all()
        assert got == contents[name], f"read mismatch for {name}"

    async def op_damage(name, corrupt):
        ref = await cluster.get_file_ref(name)
        pi = int(rng.integers(0, len(ref.parts)))
        part = ref.parts[pi]
        chunks = part.data + part.parity
        hurt = {c for (p_, c) in damaged[name] if p_ == pi}
        if len(hurt) >= 2:  # p == 2: stay reconstructible
            return
        ci = int(rng.choice(
            [c for c in range(len(chunks)) if c not in hurt]))
        location = chunks[ci].locations[0]
        ext = location.slab_extent()
        if ext is None:
            return  # shared content-addressed chunk already damaged
        path, off, ln = ext
        if corrupt:
            with open(path, "r+b") as f:
                at = off + int(rng.integers(0, ln))
                f.seek(at)
                byte = f.read(1)
                f.seek(at)
                f.write(bytes([byte[0] ^ 0x01]))
        else:
            await location.delete()
        damaged[name].add((pi, ci))

    async def op_resilver(name):
        ref = await cluster.get_file_ref(name)
        await ref.resilver(cluster.get_destination(cluster.get_profile()))
        await cluster.write_file_ref(name, ref)
        damaged[name] = set()
        report = await (await cluster.get_file_ref(name)).verify()
        assert report.integrity() == FileIntegrity.VALID
        await op_read(name)

    async def main():
        await op_write("obj0")
        for step in range(30):
            name = list(contents)[int(rng.integers(0, len(contents)))]
            op = rng.choice(["write", "overwrite", "read", "corrupt",
                             "delete", "resilver", "compact"])
            if op == "write":
                await op_write(f"obj{len(contents)}")
            elif op == "overwrite":
                await op_write(name)
            elif op == "read":
                await op_read(name)
            elif op == "corrupt":
                await op_damage(name, corrupt=True)
                await op_read(name)
            elif op == "delete":
                await op_damage(name, corrupt=False)
                await op_read(name)
            elif op == "resilver":
                await op_resilver(name)
            elif op == "compact":
                # mid-churn compaction must preserve every live extent
                # (dead ones are exactly the reclaimable set)
                for d in dirs:
                    await asyncio.to_thread(slab.get_store(d).compact)
                await op_read(name)
        for name in contents:
            await op_resilver(name)

    bounded(lambda: asyncio.run(main()))


def test_chaos_scrub_daemon_under_concurrent_churn(tmp_path):
    """The scrub daemon runs (with rolling restarts) WHILE the cluster
    churns: concurrent writes, deletes, mid-write corruption, and
    resilver.  Afterwards every object reads byte-identical, a final
    scrub pass leaves everything Valid, and the daemon stops cleanly —
    under SANITIZE=1 the conftest additionally fails the session if
    any scrub task leaked.  Runs in virtual time: the daemon's
    interval sleeps and the convergence poll compress to nothing, so
    the soak can afford generous virtual deadlines."""
    from chunky_bits_tpu_torch.cluster.scrub import ScrubDaemon

    rng = np.random.default_rng(17)
    root = tmp_path / "scrubbed"
    dirs = []
    for i in range(6):
        d = root / f"disk{i}"
        d.mkdir(parents=True)
        dirs.append(str(d))
    meta = root / "meta"
    meta.mkdir()
    cluster: Cluster = None  # type: ignore[assignment]
    contents: dict[str, bytes] = {}

    async def write(name):
        size = int(rng.integers(1, 30000))
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        await cluster.write_file(name, aio.BytesReader(payload),
                                 cluster.get_profile())
        contents[name] = payload

    async def corrupt_one(name):
        """Mid-churn corruption: flip a byte in one live extent (at
        most one damaged chunk per object between repairs — p=2 keeps
        it reconstructible even while the daemon races a resilver)."""
        ref = await cluster.get_file_ref(name)
        part = ref.parts[int(rng.integers(0, len(ref.parts)))]
        chunk = part.data[int(rng.integers(0, len(part.data)))]
        ext = chunk.locations[0].slab_extent()
        if ext is None:
            return
        path, off, ln = ext
        with open(path, "r+b") as f:
            at = off + int(rng.integers(0, ln))
            f.seek(at)
            byte = f.read(1)
            f.seek(at)
            f.write(bytes([byte[0] ^ 0x10]))

    async def main():
        nonlocal cluster
        cluster = Cluster.from_obj({
            "destinations": [{"location": f"slab:{x}"} for x in dirs],
            "metadata": {"type": "path", "format": "yaml",
                         "path": str(meta)},
            "profiles": {"default": {"data": 3, "parity": 2,
                                     "chunk_size": 12}},
        })
        daemon = ScrubDaemon(cluster, bytes_per_sec=50_000_000,
                             interval_seconds=0.01)
        daemon.start()
        try:
            await write("obj0")
            for step in range(14):
                name = list(contents)[
                    int(rng.integers(0, len(contents)))]
                op = rng.choice(["write", "read", "corrupt",
                                 "delete", "resilver", "restart"])
                if op == "write":
                    await write(f"obj{len(contents)}")
                elif op == "read":
                    got = await cluster.file_read_builder(
                        await cluster.get_file_ref(name)).read_all()
                    assert got == contents[name]
                elif op == "corrupt":
                    await corrupt_one(name)
                elif op == "delete":
                    ref = await cluster.get_file_ref(name)
                    part = ref.parts[0]
                    loc = part.parity[0].locations[0]
                    try:
                        await loc.delete()
                    except Exception:  # noqa: BLE001 — the daemon may
                        pass  # have repaired/deleted it concurrently
                elif op == "resilver":
                    ref = await cluster.get_file_ref(name)
                    await ref.resilver(cluster.get_destination(
                        cluster.get_profile()))
                    await cluster.write_file_ref(name, ref)
                elif op == "restart":
                    # rolling restart: stop AND await, then start anew
                    await daemon.stop()
                    daemon.start()
                await asyncio.sleep(0.005)
            # quiesce churn; let the daemon repair remaining damage
            deadline = asyncio.get_running_loop().time() + 30.0
            while True:
                ok = True
                for name in contents:
                    report = await (await cluster.get_file_ref(name)
                                    ).verify()
                    if report.integrity() != FileIntegrity.VALID:
                        ok = False
                if ok:
                    break
                assert asyncio.get_running_loop().time() < deadline, \
                    "scrub daemon never converged the namespace"
                await asyncio.sleep(0.05)
        finally:
            await daemon.stop()
        assert daemon.stats().passes >= 1
        for name, payload in contents.items():
            got = await cluster.file_read_builder(
                await cluster.get_file_ref(name)).read_all()
            assert got == payload, f"post-churn mismatch for {name}"

    bounded(lambda: sim_run(main()))


def test_chaos_disk_full_on_one_slab_destination(tmp_path, monkeypatch):
    """One packed destination returns ENOSPC on every append: writes
    fail over to the surviving nodes (the writer invalidates the full
    node), reads stay byte-identical, and once space returns a
    resilver re-places onto the recovered node."""
    import errno

    from chunky_bits_tpu_torch.file import slab

    rng = np.random.default_rng(19)
    root = tmp_path / "full"
    dirs = []
    for i in range(6):
        d = root / f"disk{i}"
        d.mkdir(parents=True)
        dirs.append(str(d))
    meta = root / "meta"
    meta.mkdir()
    cluster = Cluster.from_obj({
        "destinations": [{"location": f"slab:{x}"} for x in dirs],
        "metadata": {"type": "path", "format": "yaml", "path": str(meta)},
        "profiles": {"default": {"data": 3, "parity": 2,
                                 "chunk_size": 12}},
    })
    full_store = slab.get_store(dirs[0])

    def out_of_space(name, data):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(full_store, "append", out_of_space)
    payload = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()

    async def main():
        await cluster.write_file("obj", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("obj")
        # nothing landed on the full node
        for part in ref.parts:
            for chunk in part.data + part.parity:
                for location in chunk.locations:
                    assert not location.target.startswith(dirs[0]), \
                        f"chunk placed on the full node: {location}"
        got = await cluster.file_read_builder(ref).read_all()
        assert got == payload
        # space returns: the node takes writes again on resilver
        monkeypatch.undo()
        await ref.parts[0].data[0].locations[0].delete()
        report = await ref.resilver(
            cluster.get_destination(cluster.get_profile()))
        assert not report.failed_writes(), report.failed_writes()
        await cluster.write_file_ref("obj", ref)
        got = await cluster.file_read_builder(
            await cluster.get_file_ref("obj")).read_all()
        assert got == payload

    bounded(lambda: asyncio.run(main()))


def test_chaos_soak_http_nodes(tmp_path):
    """The same invariants over in-process HTTP storage nodes: damage is
    dropped/corrupted in the node stores, repair re-places over HTTP."""
    from tests.http_node import FakeHttpNode

    rng = np.random.default_rng(3)
    meta = tmp_path / "meta"
    meta.mkdir()

    async def main():
        nodes = [await FakeHttpNode().start() for _ in range(6)]
        try:
            cluster = Cluster.from_obj({
                "destinations": [{"location": n.url + "/"} for n in nodes],
                "metadata": {"type": "path", "format": "yaml",
                             "path": str(meta)},
                "profiles": {"default": {"data": 3, "parity": 2,
                                         "chunk_size": 12}},
            })
            contents: dict[str, bytes] = {}
            damaged: dict[str, set] = {}

            def find_node(url: str):
                for n in nodes:
                    if url.startswith(n.url):
                        return n, url[len(n.url) + 1:]
                raise AssertionError(url)

            async def write(name):
                size = int(rng.integers(1, 40000))
                payload = rng.integers(0, 256, size,
                                       dtype=np.uint8).tobytes()
                await cluster.write_file(name, aio.BytesReader(payload),
                                         cluster.get_profile())
                contents[name] = payload
                damaged[name] = set()

            async def damage(name):
                ref = await cluster.get_file_ref(name)
                pi = int(rng.integers(0, len(ref.parts)))
                part = ref.parts[pi]
                chunks = part.data + part.parity
                hurt = {c for (p_, c) in damaged[name] if p_ == pi}
                if len(hurt) >= 2:
                    return
                ci = int(rng.choice(
                    [c for c in range(len(chunks)) if c not in hurt]))
                node, key = find_node(str(chunks[ci].locations[0]))
                if key not in node.store:
                    return
                if rng.random() < 0.5:
                    raw = bytearray(node.store[key])
                    raw[int(rng.integers(0, len(raw)))] ^= 1
                    node.store[key] = bytes(raw)
                else:
                    del node.store[key]
                damaged[name].add((pi, ci))

            async def repair(name):
                ref = await cluster.get_file_ref(name)
                await ref.resilver(
                    cluster.get_destination(cluster.get_profile()))
                await cluster.write_file_ref(name, ref)
                damaged[name] = set()
                report = await (await cluster.get_file_ref(name)).verify()
                assert report.integrity() == FileIntegrity.VALID

            await write("obj0")
            for _ in range(25):
                name = list(contents)[int(rng.integers(0, len(contents)))]
                op = rng.choice(["write", "read", "damage", "repair"])
                if op == "write":
                    await write(f"obj{len(contents)}")
                elif op == "read":
                    got = await (await cluster.get_file_ref(name)) \
                        .read_builder().read_all()
                    assert got == contents[name]
                elif op == "damage":
                    await damage(name)
                    got = await (await cluster.get_file_ref(name)) \
                        .read_builder().read_all()
                    assert got == contents[name]
                else:
                    await repair(name)
            for name in contents:
                await repair(name)
        finally:
            for n in nodes:
                await n.stop()

    bounded(lambda: asyncio.run(main()))
