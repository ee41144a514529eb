"""The port's repair planner (``chunky_bits_tpu_torch/cluster/repair.py``),
held against ``tests/test_repair.py`` and against the JAX package's planner.

The assertions of ``tests/test_repair.py`` run on the ``torch``, ``numpy``
and ``native`` backends, with exact helper-byte counts and every byte of
the pass in the token bucket's accounting.  Without a profiler both
packages verify local and slab replicas through the native fused
read+hash, so the planner re-reads a corrupt victim to localize the damage
(``bytes_localized`` = the chunk), and every scrub and repair counter
equals the JAX package's (``test_counters_equal_the_jax_package_without_a_
profiler``); with a profiler attached both take the generic path, whose
verify read hands the corrupt bytes over (``bytes_localized`` 0).  Time is
the fake clock of ``test_torch_scrub.py``.
"""

import asyncio
import os

import numpy as np
import pytest

from chunky_bits_tpu.cluster.repair import merge_ranges as jax_merge
from chunky_bits_tpu.file.chunk import BlockDigests as JaxBlockDigests
from chunky_bits_tpu_torch.cluster import Cluster
from chunky_bits_tpu_torch.cluster.repair import (RepairPlanner,
                                                  merge_ranges)
from chunky_bits_tpu_torch.cluster.scrub import ScrubDaemon
from chunky_bits_tpu_torch.file.chunk import BlockDigests
from chunky_bits_tpu_torch.file.location import Location
from chunky_bits_tpu_torch.file.profiler import new_profiler
from chunky_bits_tpu_torch.ops import batching
from chunky_bits_tpu_torch.utils import aio
from tests.test_torch_file import run
from tests.test_torch_scrub import (FakeClock, fake_clock,  # noqa: F401
                                    verify_valid)
from tests.test_torch_slab import (flip_byte, make_cluster_obj, payload_of,
                                   read_back, write_payload)

CHUNK = 1 << 14


@pytest.fixture(autouse=True)
def torch_default(monkeypatch, fake_clock):  # noqa: F811
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    for knob in ("CODE", "METADATA_KIND", "REPAIR_BLOCK_BYTES",
                 "SCRUB_BYTES_PER_SEC", "CACHE_BYTES", "HEDGE_MS"):
        monkeypatch.delenv("CHUNKY_BITS_TORCH_" + knob, raising=False)


def meter_bucket(daemon):
    """Every take() of the pass (verification and repair share the one
    bucket) lands in the returned list."""
    taken = []
    orig = daemon._bucket.take

    async def spy(nbytes):
        taken.append(nbytes)
        await orig(nbytes)

    daemon._bucket.take = spy
    return taken


def treed_cluster(tmp_path, packed=True, code="rs", trees=4096,
                  backend="torch"):
    return Cluster.from_obj(make_cluster_obj(
        tmp_path, packed=packed, chunk_log2=14, code=code,
        tunables={"repair_block_bytes": trees, "backend": backend}))


def plant_replica(tmp_path, chunk, n_nodes=5, packed=True):
    """A second, healthy replica of ``chunk`` on another node."""
    victim_root = os.path.dirname(chunk.locations[0].target)
    other = next(d for d in (os.path.join(str(tmp_path), f"disk{i}")
                             for i in range(n_nodes)) if d != victim_root)
    return Location.parse(f"{'slab:' if packed else ''}{other}/"
                          f"{chunk.hash}")


# ---- block digests and range merging, against the JAX package ----

def test_block_digests_localize_and_verify():
    data = bytearray(payload_of(10_000, 0))
    bd = BlockDigests.from_buf(data, 4096)
    assert bd.to_obj() == JaxBlockDigests.from_buf(data, 4096).to_obj()
    assert len(bd.digests) == 3 and bd.covers(10_000)
    assert bd.damaged_ranges(data) == []
    data[5000] ^= 1
    assert bd.damaged_ranges(data) == [(4096, 4096)]
    data[5000] ^= 1
    data[0] ^= 1
    data[9000] ^= 1
    assert bd.damaged_ranges(data) == [(0, 4096), (8192, 1808)]
    data[5000] ^= 1
    assert bd.damaged_ranges(data) == [(0, 10_000)]
    data[0] ^= 1
    data[9000] ^= 1
    assert bd.damaged_ranges(data[:5]) is None
    assert bd.damaged_ranges(data + b"x" * 5000) is None
    assert bd.verify_range(bytes(data[4096:8192]), 4096) is False
    data[5000] ^= 1
    assert bd.verify_range(bytes(data[4096:8192]), 4096) is True
    assert bd.verify_range(bytes(data[8192:]), 8192) is True
    data[9000] ^= 1
    assert bd.verify_range(bytes(data[8192:]), 8192) is False
    assert bd.verify_range(bytes(data[1:4097]), 1) is None
    assert bd.verify_range(b"", 0) is None
    for garbage in (None, 7, [], {}, {"size": 0, "sha256": []},
                    {"size": 1024}, {"size": 1024, "sha256": ["zz"]}):
        assert BlockDigests.from_obj(garbage) is None


def test_merge_ranges_equals_jax():
    assert merge_ranges([]) == []
    assert merge_ranges([(0, 10), (10, 5)]) == [(0, 15)]
    assert merge_ranges([(0, 10), (5, 10), (30, 2)]) == [(0, 15), (30, 2)]
    rng = np.random.default_rng(3)
    for _ in range(200):
        ranges = [(int(s), int(n)) for s, n in
                  rng.integers(0, 100, (int(rng.integers(0, 8)), 2))]
        assert merge_ranges(ranges) == jax_merge(ranges)


def test_encode_path_writes_trees_only_for_multiblock_chunks(tmp_path):
    cluster = treed_cluster(tmp_path)
    write_payload(cluster, "big", 3 * CHUNK, seed=1)
    write_payload(cluster, "small", 600, seed=2)

    async def main():
        big = await cluster.get_file_ref("big")
        for chunk in big.parts[0].data + big.parts[0].parity:
            assert chunk.blocks is not None and chunk.blocks.size == 4096
            assert chunk.blocks.covers(big.parts[0].chunksize)
        small = await cluster.get_file_ref("small")
        for chunk in small.parts[0].data + small.parts[0].parity:
            assert chunk.blocks is None

    run(main())


# ---- the plans, with exact byte accounting ----

@pytest.mark.parametrize("packed", [True, False])
def test_decode_plan_reads_d_blocks_not_d_chunks(tmp_path, packed):
    """One flipped byte in the only replica of one chunk: the SAME block
    off d helpers (3 x 4 KiB), rebuilt in place with no metadata
    republish; every byte of the pass is in the bucket."""
    cluster = treed_cluster(tmp_path, packed=packed)
    payload = write_payload(cluster, "obj", 3 * CHUNK, seed=3)

    async def main():
        ref = await cluster.get_file_ref("obj")
        meta_path = os.path.join(str(tmp_path), "meta", "obj")
        with open(meta_path, "rb") as f:
            meta_before = f.read()
        flip_byte(ref.parts[0].data[1].locations[0], 5000)
        daemon = ScrubDaemon(cluster, bytes_per_sec=0)
        taken = meter_bucket(daemon)
        stats = await daemon.run_once()
        rs = stats.repair
        assert stats.corrupt == 1 and stats.repaired == 1
        assert rs["plans_decode"] == 1 and rs["plans_copy"] == 0
        assert rs["helper_bytes_decode"] == 3 * 4096
        assert rs["helper_bytes_replica"] == 0
        assert rs["bytes_localized"] == CHUNK  # one victim re-read
        assert rs["bytes_rebuilt"] == 4096
        assert rs["bytes_written"] == CHUNK
        assert rs["helper_bytes_per_rebuilt_byte"] == 3.0
        assert sum(taken) == (stats.bytes_verified + rs["bytes_localized"]
                              + rs["helper_bytes_decode"]
                              + rs["bytes_written"])
        with open(meta_path, "rb") as f:
            assert f.read() == meta_before
        assert await read_back(cluster, "obj") == payload
        assert await verify_valid(cluster, "obj")
        stats2 = await daemon.run_once()
        assert stats2.corrupt == stats.corrupt

    run(main())


def test_verify_phase_bytes_make_localization_free(tmp_path):
    cluster = treed_cluster(tmp_path, packed=False)
    payload = write_payload(cluster, "obj", 3 * CHUNK, seed=11)

    async def main():
        ref = await cluster.get_file_ref("obj")
        flip_byte(ref.parts[0].data[0].locations[0], 7000)
        daemon = ScrubDaemon(cluster, bytes_per_sec=0,
                             profiler=new_profiler()[0])
        rs = (await daemon.run_once()).repair
        assert rs["bytes_localized"] == 0, rs
        assert rs["helper_bytes_decode"] == 3 * 4096, rs
        assert await read_back(cluster, "obj") == payload

    run(main())


def test_copy_plan_prefers_replica_over_decode(tmp_path):
    cluster = treed_cluster(tmp_path)
    payload = write_payload(cluster, "obj", 3 * CHUNK, seed=4)

    async def main():
        ref = await cluster.get_file_ref("obj")
        chunk = ref.parts[0].data[0]
        replica = plant_replica(tmp_path, chunk)
        await replica.write(bytes(await chunk.locations[0].read()))
        chunk.locations.append(replica)
        await cluster.write_file_ref("obj", ref)
        flip_byte(chunk.locations[0], 9000)
        rs = (await ScrubDaemon(cluster, bytes_per_sec=0).run_once()).repair
        assert rs["plans_copy"] == 1 and rs["plans_decode"] == 0
        assert rs["helper_bytes_replica"] == 4096
        assert rs["helper_bytes_decode"] == 0
        assert rs["bytes_rebuilt"] == 4096
        assert await read_back(cluster, "obj") == payload

    run(main())


def test_two_lost_chunks_rebuild_in_one_decode_plan(tmp_path):
    cluster = treed_cluster(tmp_path)
    payload = write_payload(cluster, "obj", 3 * CHUNK, seed=5)

    async def main():
        ref = await cluster.get_file_ref("obj")
        flip_byte(ref.parts[0].data[0].locations[0], 100)
        flip_byte(ref.parts[0].parity[1].locations[0], 200)
        dispatches = []
        real = batching.ReconstructBatcher._submit

        async def spy(self, key, arrays):
            dispatches.append(key)
            return await real(self, key, arrays)

        batching.ReconstructBatcher._submit = spy
        try:
            stats = await ScrubDaemon(cluster, bytes_per_sec=0).run_once()
        finally:
            batching.ReconstructBatcher._submit = real
        rs = stats.repair
        assert stats.corrupt == 2 and stats.repaired == 2
        assert rs["plans_decode"] == 1
        assert rs["helper_bytes_decode"] == 3 * 4096
        # both chunks rebuild from one range: one decode request
        assert len(dispatches) == 1 and dispatches[0][3] == (0, 4)
        assert await read_back(cluster, "obj") == payload
        assert await verify_valid(cluster, "obj")

    run(main())


def test_unrecoverable_part_falls_back_and_counts_failure(tmp_path):
    cluster = treed_cluster(tmp_path)
    write_payload(cluster, "obj", 3 * CHUNK, seed=6)

    async def main():
        ref = await cluster.get_file_ref("obj")
        for chunk in (ref.parts[0].data[0], ref.parts[0].data[1],
                      ref.parts[0].parity[0]):
            flip_byte(chunk.locations[0], 50)
        stats = await ScrubDaemon(cluster, bytes_per_sec=0).run_once()
        assert stats.repair["plans_fallback"] >= 1
        assert stats.repair_failures >= 1
        assert stats.repaired == 0

    run(main())


def test_chunk_with_no_locations_falls_back_to_resilver(tmp_path):
    cluster = treed_cluster(tmp_path)
    payload = write_payload(cluster, "obj", 3 * CHUNK, seed=8)

    async def main():
        ref = await cluster.get_file_ref("obj")
        victim = ref.parts[0].data[2]
        await victim.locations[0].delete()
        victim.locations.clear()
        await cluster.write_file_ref("obj", ref)
        stats = await ScrubDaemon(cluster, bytes_per_sec=0).run_once()
        assert stats.repair["plans_fallback"] >= 1
        assert stats.repaired >= 1
        ref2 = await cluster.get_file_ref("obj")
        assert ref2.parts[0].data[2].locations
        assert await read_back(cluster, "obj") == payload
        assert await verify_valid(cluster, "obj")

    run(main())


def test_old_refs_without_trees_repair_as_before(tmp_path):
    cluster = treed_cluster(tmp_path, trees=0)
    payload = write_payload(cluster, "obj", 3 * CHUNK, seed=7)

    async def main():
        ref = await cluster.get_file_ref("obj")
        assert ref.parts[0].data[0].blocks is None
        flip_byte(ref.parts[0].data[0].locations[0], 5000)
        stats = await ScrubDaemon(cluster, bytes_per_sec=0).run_once()
        rs = stats.repair
        assert stats.repaired == 1 and rs["plans_decode"] == 1
        assert rs["helper_bytes_decode"] == 3 * CHUNK
        assert rs["bytes_localized"] == 0
        assert rs["bytes_rebuilt"] == CHUNK
        assert await read_back(cluster, "obj") == payload

    run(main())


@pytest.mark.parametrize("backend", ["torch", "numpy", "native"])
def test_partial_rebuild_byte_identity_fuzz(tmp_path, backend):
    """Random damage repaired three ways (localized, whole-chunk, legacy
    resilver) converges every replica to the same bytes."""
    legs = (("treed", True, True), ("untreed", False, True),
            ("legacy", True, False))
    payload = payload_of(3 * 4096 + 777, 9)

    async def one(name, trees, planner):
        cluster = Cluster.from_obj(make_cluster_obj(
            tmp_path / f"{backend}-{name}", chunk_log2=12,
            tunables={"backend": backend,
                      "repair_block_bytes": 1024 if trees else 0}))
        await cluster.write_file("obj", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("obj")
        damage_rng = np.random.default_rng(1234)
        for part in ref.parts:
            chunks = part.data + part.parity
            for ci in damage_rng.choice(len(chunks), size=2, replace=False):
                offset = int(damage_rng.integers(0, part.chunksize))
                flip_byte(chunks[ci].locations[0], offset)
        stats = await ScrubDaemon(cluster, bytes_per_sec=0,
                                  planner=planner).run_once()
        assert stats.corrupt >= 2, (name, stats)
        assert await verify_valid(cluster, "obj"), name
        assert await read_back(cluster, "obj") == payload, name
        ref2 = await cluster.get_file_ref("obj")
        rebuilt = {}
        for c in (c for p in ref2.parts for c in p.data + p.parity):
            # the legacy leg, as in the JAX package, may list the corrupt
            # replica beside the one its resilver placed until the next
            # pass rewrites it; the replicas that verify are the same
            good = {b for b in [await loc.read() for loc in c.locations]
                    if c.hash.verify(b)}
            assert len(good) == 1, (name, str(c.hash))
            rebuilt[str(c.hash)] = good.pop()
        return rebuilt

    async def main():
        results = [await one(*leg) for leg in legs]
        assert results[0] == results[1] == results[2]

    run(main())


def test_scrub_planner_converges_under_churn(tmp_path, fake_clock):  # noqa: F811
    """Localized corruption repaired while a writer overwrites one object
    and adds others between passes of the running daemon: the damage
    converges, the overwrite wins, every repair byte is metered."""
    cluster = treed_cluster(tmp_path)
    payloads = {f"o{i}": write_payload(cluster, f"o{i}", 3 * CHUNK, seed=i)
                for i in range(4)}

    async def main():
        for i in (0, 2):
            ref = await cluster.get_file_ref(f"o{i}")
            flip_byte(ref.parts[0].data[i % 3].locations[0], 6000 + i)
        daemon = ScrubDaemon(cluster, bytes_per_sec=0,
                             interval_seconds=0.01)
        taken = meter_bucket(daemon)
        daemon.start()
        for n in range(4):
            data = payload_of(3 * CHUNK, 100 + n)
            name = "o3" if n == 0 else f"churn{n}"
            await cluster.write_file(name, aio.BytesReader(data),
                                     cluster.get_profile())
            payloads[name] = data
            await asyncio.sleep(0.01)
        for _ in range(1000):  # bounded: 10 s of real time at most
            stats = daemon.stats()
            if stats.repaired >= 2 and stats.passes >= 2:
                break
            await asyncio.sleep(0.01)
        await daemon.stop()
        stats = daemon.stats()
        assert stats.repaired >= 2, stats
        rs = stats.repair
        assert rs["plans_decode"] >= 2
        assert sum(taken) >= (rs["helper_bytes_decode"]
                              + rs["helper_bytes_replica"]
                              + rs["bytes_localized"] + rs["bytes_written"])
        for name, data in payloads.items():
            assert await read_back(cluster, name) == data, name

    run(main())


# ---- pm-msr: the msr plan ----

def pm_cluster(tmp_path, d=5, p=4, chunk_log2=14, packed=False,
               backend="torch"):
    return Cluster.from_obj(make_cluster_obj(
        tmp_path, packed=packed, d=d, p=p, chunk_log2=chunk_log2,
        n_nodes=d + p, code="pm-msr", tunables={"backend": backend}))


@pytest.mark.parametrize("backend", ["torch", "numpy", "native"])
def test_msr_plan_regenerates_single_loss_at_two_x(tmp_path, backend):
    """A pm-msr part losing ONE chunk regenerates from d' = 2(d-1)
    beta-sized projections: exactly 2 x chunksize of helper bytes where
    the rs floor is d x chunksize, metered, labelled pm-msr."""
    d, p = 5, 4
    alpha, dh = d - 1, 2 * (d - 1)
    cluster = pm_cluster(tmp_path, d=d, p=p, backend=backend)
    payload = write_payload(cluster, "obj", d * CHUNK, seed=3)

    async def main():
        ref = await cluster.get_file_ref("obj")
        assert all(part.code == "pm-msr" for part in ref.parts)
        os.remove(ref.parts[0].data[2].locations[0].target)
        daemon = ScrubDaemon(cluster, bytes_per_sec=0)
        taken = meter_bucket(daemon)
        rep = (await daemon.run_once()).repair
        assert rep["plans_msr"] == 1 and rep["plans_decode"] == 0, rep
        assert rep["helper_bytes_msr"] == dh * (CHUNK // alpha) == 2 * CHUNK
        assert rep["bytes_rebuilt"] == CHUNK
        assert rep["by_code"]["pm-msr"]["plans_msr"] == 1
        assert rep["by_code"]["rs"]["plans_msr"] == 0
        assert sum(taken) >= dh * CHUNK + CHUNK
        assert await read_back(cluster, "obj") == payload
        verify = await ref.parts[0].verify(
            cluster.tunables.location_context())
        assert str(verify.integrity()) == "Valid", str(verify)

    run(main())


@pytest.mark.parametrize("packed", [False, True], ids=["paths", "slabs"])
def test_msr_plan_works_on_slab_and_path_replicas(tmp_path, packed):
    d, p, chunk = 3, 2, 1 << 13
    cluster = pm_cluster(tmp_path, d=d, p=p, chunk_log2=13, packed=packed)
    payload = write_payload(cluster, "obj", d * chunk, seed=5)

    async def main():
        ref = await cluster.get_file_ref("obj")
        flip_byte(ref.parts[0].data[1].locations[0], 100)
        rep = (await ScrubDaemon(cluster, bytes_per_sec=0).run_once()).repair
        assert rep["plans_msr"] == 1, rep
        assert rep["helper_bytes_msr"] == 2 * (d - 1) * (chunk // (d - 1))
        assert await read_back(cluster, "obj") == payload

    run(main())


def test_pm_msr_multi_loss_falls_back_to_decode_plan(tmp_path):
    d, p, chunk = 5, 4, 1 << 13
    cluster = pm_cluster(tmp_path, d=d, p=p, chunk_log2=13)
    payload = write_payload(cluster, "obj", d * chunk, seed=7)

    async def main():
        ref = await cluster.get_file_ref("obj")
        os.remove(ref.parts[0].data[0].locations[0].target)
        os.remove(ref.parts[0].parity[1].locations[0].target)
        stats = await ScrubDaemon(cluster, bytes_per_sec=0).run_once()
        rep = stats.repair
        assert rep["plans_msr"] == 0 and rep["plans_decode"] == 1, rep
        assert rep["by_code"]["pm-msr"]["helper_bytes_decode"] == d * chunk
        assert stats.repaired == 2
        assert await read_back(cluster, "obj") == payload

    run(main())


def test_pm_msr_copy_plan_still_wins_with_replicas(tmp_path):
    d, p, chunk = 3, 2, 1 << 13
    cluster = pm_cluster(tmp_path, d=d, p=p, chunk_log2=13)
    payload = write_payload(cluster, "obj", d * chunk, seed=11)

    async def main():
        ref = await cluster.get_file_ref("obj")
        chunk0 = ref.parts[0].data[0]
        replica = plant_replica(tmp_path, chunk0, d + p, packed=False)
        await replica.write(bytes(await chunk0.locations[0].read()))
        chunk0.locations.append(replica)
        await cluster.write_file_ref("obj", ref)
        flip_byte(chunk0.locations[0], 42)
        rep = (await ScrubDaemon(cluster, bytes_per_sec=0).run_once()).repair
        assert rep["plans_copy"] == 1 and rep["plans_msr"] == 0, rep
        assert rep["by_code"]["pm-msr"]["plans_copy"] == 1
        assert await read_back(cluster, "obj") == payload

    run(main())


def test_unknown_code_part_is_hands_off_fallback(tmp_path):
    cluster = Cluster.from_obj(make_cluster_obj(tmp_path, packed=False))
    write_payload(cluster, "obj", 3 * 4096, seed=13)
    write_payload(cluster, "ok", 3 * 4096, seed=14)

    async def main():
        obj = await cluster.metadata.read("obj")
        for part in obj["parts"]:
            part["code"] = "future-code"
        await cluster.metadata.write("obj", obj)
        ref = await cluster.get_file_ref("obj")
        flip_byte(ref.parts[0].data[0].locations[0], 10)
        stats = await ScrubDaemon(cluster, bytes_per_sec=0).run_once()
        rep = stats.repair
        assert rep["plans_fallback"] >= 1 and rep["bytes_written"] == 0
        assert stats.repair_failures >= 1
        assert len(await read_back(cluster, "ok")) == 3 * 4096

    run(main())


def test_msr_plan_survives_corrupt_helper(tmp_path):
    d, p, chunk = 3, 3, 1 << 13
    cluster = pm_cluster(tmp_path, d=d, p=p, chunk_log2=13)
    payload = write_payload(cluster, "obj", d * chunk, seed=17)

    async def main():
        ref = await cluster.get_file_ref("obj")
        os.remove(ref.parts[0].data[0].locations[0].target)
        daemon = ScrubDaemon(cluster, bytes_per_sec=0)
        planner = daemon._planner
        orig = planner.repair_part
        rotted = []

        async def rot_then_repair(part, verdicts, cx, pipe, payloads=None):
            if not rotted:
                flip_byte(part.data[1].locations[0], 99)
                rotted.append(True)
            return await orig(part, verdicts, cx, pipe, payloads=payloads)

        planner.repair_part = rot_then_repair
        rep = (await daemon.run_once()).repair
        assert rep["plans_msr"] == 1, rep
        assert await read_back(cluster, "obj") == payload

    run(main())


def test_planner_alone_is_unmetered_and_registers(tmp_path):
    """A planner built outside a daemon has a rate-0 bucket (no waits)
    and registers as a ``repair`` metrics source."""
    from chunky_bits_tpu_torch.obs.metrics import get_registry

    planner = RepairPlanner(backend="torch")
    assert planner.bucket.rate == 0
    assert any(src is planner for src in get_registry().sources("repair"))
    assert planner.stats().savings_ratio() is None
