"""The port's content-addressed read cache (``file/chunk_cache.py``) and
the cluster's parsed file-reference cache, held against the cases of
``tests/test_chunk_cache.py``: the LRU byte budget, verify-then-insert,
single flight (including a winner that dies), ``contains``, byte
identity with the cache on and off (a rebuilt row cached and served),
whole chunks only under seek/take, the profiler's cache stanza, the
``cache_bytes`` tunable, and the file-reference cache fenced by writes.
Clusters run the ``torch`` backend; every event loop runs under a
deadline.
"""

import asyncio
import hashlib
import os

import numpy as np
import pytest

from chunky_bits_tpu_torch.cluster import Cluster
from chunky_bits_tpu_torch.cluster.tunables import CACHE_BYTES_ENV, Tunables
from chunky_bits_tpu_torch.errors import SerdeError
from chunky_bits_tpu_torch.file import AnyHash, ChunkCache, new_profiler
from chunky_bits_tpu_torch.utils import aio

CHUNK_SIZE = 1 << 16


def arun(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def synthetic_bytes(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def make_cluster(tmp_path, cache_bytes: int = 0,
                 backend: str = "torch") -> Cluster:
    dirs = []
    for i in range(5):
        d = tmp_path / f"disk{i}"
        d.mkdir(exist_ok=True)
        dirs.append(str(d))
    meta = tmp_path / "meta"
    meta.mkdir(exist_ok=True)
    return Cluster.from_obj({
        "destinations": [{"location": d} for d in dirs],
        "metadata": {"type": "path", "format": "yaml", "path": str(meta)},
        "profiles": {"default": {"data": 3, "parity": 2,
                                 "chunk_size": 16}},
        "tunables": {"cache_bytes": cache_bytes, "backend": backend},
    })


async def read_all(cluster: Cluster, path: str) -> bytes:
    reader = await cluster.read_file(path)
    out = []
    while True:
        data = await reader.read(1 << 20)
        if not data:
            break
        out.append(data)
    return b"".join(out)


# ---- the cache itself ----

def test_lru_eviction_under_byte_budget():
    cache = ChunkCache(100)
    bufs = {bytes([i]) * 32: bytes([i]) * 40 for i in range(3)}
    for digest, buf in bufs.items():
        assert cache._insert(digest, buf) is not None
    assert cache.evictions == 1
    assert cache.size_bytes == 80
    assert len(cache) == 2
    digests = list(bufs)
    assert cache.get(digests[0]) is None
    assert cache.get(digests[1]) == bufs[digests[1]]
    assert cache._insert(b"x" * 32, b"y" * 40) is not None
    assert cache.get(digests[2]) is None
    assert cache.get(digests[1]) is not None
    assert cache._insert(b"z" * 32, b"w" * 101) is None
    assert cache.size_bytes <= 100
    with pytest.raises(ValueError):
        ChunkCache(0)


def test_contains_probes_without_counting_or_freshening():
    cache = ChunkCache(100)
    cache._insert(b"a" * 32, b"1" * 40)
    cache._insert(b"b" * 32, b"2" * 40)
    # probing the LRU entry must not save it from eviction
    assert cache.contains(b"a" * 32)
    assert not cache.contains(b"c" * 32)
    assert cache.hits == 0
    cache._insert(b"c" * 32, b"3" * 40)
    assert not cache.contains(b"a" * 32)
    stats = cache.stats()
    assert (stats.hits, stats.inserts, stats.evictions, stats.entries) == \
        (0, 3, 1, 2)
    assert stats.to_obj()["size_bytes"] == 80
    assert str(stats).startswith("Cache<")


def test_insert_verified_rejects_corruption():
    async def main():
        cache = ChunkCache(1 << 20)
        good = b"payload-bytes"
        hash_ = AnyHash.from_buf(good)
        assert not await cache.insert_verified(hash_, b"evil-bytes!!!")
        assert cache.rejects == 1 and len(cache) == 0
        assert await cache.insert_verified(hash_, good)
        assert cache.get(hash_.value.digest) == good

    arun(main())


@pytest.mark.parametrize("outcome", ["bytes", "none"])
def test_single_flight_concurrent_readers(outcome):
    """N concurrent readers of one digest run one fetch; the others get
    its verified buffer, or all get None when the chunk is unreachable."""
    async def main():
        cache = ChunkCache(1 << 20)
        payload = b"c" * 1000
        digest = hashlib.sha256(payload).digest()
        fetches = {"n": 0}
        gate = asyncio.Event()

        async def fetch():
            fetches["n"] += 1
            await gate.wait()
            return payload if outcome == "bytes" else None

        tasks = [asyncio.ensure_future(cache.get_or_fetch(digest, fetch))
                 for _ in range(8)]
        await asyncio.sleep(0)
        gate.set()
        results = await asyncio.gather(*tasks)
        assert fetches["n"] == 1
        assert cache.misses == 1 and cache.coalesced == 7
        if outcome == "bytes":
            assert all(r == payload for r in results)
            assert cache.get(digest) == payload
        else:
            assert results == [None] * 8 and len(cache) == 0

    arun(main())


def test_single_flight_winner_death_does_not_doom_waiters():
    async def main():
        cache = ChunkCache(1 << 20)
        payload = b"d" * 64
        digest = hashlib.sha256(payload).digest()
        started = asyncio.Event()

        async def hanging_fetch():
            started.set()
            await asyncio.Future()  # parked until cancelled

        async def good_fetch():
            return payload

        winner = asyncio.ensure_future(
            cache.get_or_fetch(digest, hanging_fetch))
        await started.wait()
        waiter = asyncio.ensure_future(cache.get_or_fetch(digest, good_fetch))
        await asyncio.sleep(0)
        winner.cancel()
        assert await waiter == payload
        with pytest.raises(asyncio.CancelledError):
            await winner

    arun(main())


# ---- byte identity with the cache in the read path ----

@pytest.mark.parametrize("backend", ["torch", "numpy"])
def test_read_byte_identity_cache_on_vs_off(tmp_path, backend):
    """Cached, uncached and rebuilt reads are byte-identical; a rebuilt
    row enters the cache and serves the next degraded read."""
    payload = synthetic_bytes(3 * CHUNK_SIZE + 12345, seed=31)

    async def main():
        cold = make_cluster(tmp_path, backend=backend)
        await cold.write_file("obj", aio.BytesReader(payload),
                              cold.get_profile(None))
        assert await read_all(cold, "obj") == payload
        hot = make_cluster(tmp_path, 64 << 20, backend)
        assert await read_all(hot, "obj") == payload
        cache = hot._chunk_caches[asyncio.get_running_loop()]
        assert cache.misses > 0 and cache.inserts > 0
        hits = cache.hits
        assert await read_all(hot, "obj") == payload
        assert cache.hits > hits
        ref = await hot.get_file_ref("obj")
        victim = ref.parts[0].data[1]
        os.remove(victim.locations[0].target)
        degraded = make_cluster(tmp_path, 64 << 20, backend)
        assert await read_all(degraded, "obj") == payload
        dcache = degraded._chunk_caches[asyncio.get_running_loop()]
        assert dcache.get(victim.cache_key()) is not None
        hits = dcache.hits
        assert await read_all(degraded, "obj") == payload
        assert dcache.hits > hits

    arun(main())


def test_read_through_a_jax_written_tree_with_the_cache(tmp_path):
    """A tree the JAX package wrote reads back through the port's cached
    serve path; the second read hits, and every cached entry is a chunk
    of the reference whose bytes hash to its key."""
    from chunky_bits_tpu.cluster import Cluster as JaxCluster
    from chunky_bits_tpu.utils import aio as jaio

    payload = synthetic_bytes(2 * CHUNK_SIZE + 999, seed=2)

    async def main():
        spec = make_cluster(tmp_path, 64 << 20, "numpy").to_obj()
        jax = JaxCluster.from_obj(spec)
        await jax.write_file("obj", jaio.BytesReader(payload),
                             jax.get_profile(None))
        ours = Cluster.from_obj(spec)
        assert await read_all(ours, "obj") == payload
        cache = ours._chunk_caches[asyncio.get_running_loop()]
        hits = cache.hits
        assert await read_all(ours, "obj") == payload
        assert cache.hits > hits
        ref = await ours.get_file_ref("obj")
        keys = {c.cache_key() for p in ref.parts for c in p.all_chunks()}
        assert set(cache._entries) <= keys
        for key, buf in cache._entries.items():
            assert hashlib.sha256(buf).digest() == key
        await jax.tunables.location_context().aclose()

    arun(main())


def test_cache_never_holds_trimmed_buffers(tmp_path):
    payload = synthetic_bytes(3 * CHUNK_SIZE + 5000, seed=5)

    async def main():
        cluster = make_cluster(tmp_path, 64 << 20)
        await cluster.write_file("obj", aio.BytesReader(payload),
                                 cluster.get_profile(None))
        ref = await cluster.get_file_ref("obj")
        got = await cluster.file_read_builder(ref).with_seek(100) \
            .with_take(1000).read_all()
        assert got == payload[100:1100]
        cache = cluster._chunk_caches[asyncio.get_running_loop()]
        assert {len(b) for b in cache._entries.values()} == \
            {ref.parts[0].chunksize}

    arun(main())


# ---- the cluster: shared batcher, file-reference cache, profiler ----

def test_cluster_shared_reconstruct_batcher(tmp_path):
    payload = synthetic_bytes(3 * CHUNK_SIZE, seed=11)

    async def main():
        cluster = make_cluster(tmp_path)
        for name in ("a", "b"):
            await cluster.write_file(name, aio.BytesReader(payload),
                                     cluster.get_profile(None))
            ref = await cluster.get_file_ref(name)
            os.remove(ref.parts[0].data[0].locations[0].target)
        loop = asyncio.get_running_loop()
        assert await asyncio.gather(read_all(cluster, "a"),
                                    read_all(cluster, "b")) == \
            [payload, payload]
        batcher = cluster._reconstruct_batchers.get(loop)
        assert batcher is not None and batcher.groups > 0
        await read_all(cluster, "a")
        assert cluster._reconstruct_batchers.get(loop) is batcher

    arun(main())


def test_file_ref_cache_fenced_by_writes(tmp_path):
    """With the cache on a hot reference parses once; a write of the
    path shows at once; a read in flight across a write never installs
    the stale parse; with the cache off every call parses."""
    payload = synthetic_bytes(2000, seed=3)

    async def main():
        cluster = make_cluster(tmp_path, 1 << 20)
        profile = cluster.get_profile(None)
        await cluster.write_file("obj", aio.BytesReader(payload), profile)
        ref1 = await cluster.get_file_ref("obj")
        assert await cluster.get_file_ref("obj") is ref1
        new_payload = synthetic_bytes(3000, seed=4)
        await cluster.write_file("obj", aio.BytesReader(new_payload),
                                 profile)
        ref2 = await cluster.get_file_ref("obj")
        assert ref2 is not ref1
        assert await read_all(cluster, "obj") == new_payload
        cluster._file_refs.clear()
        real_read = cluster.metadata.read
        release = asyncio.Event()

        async def slow_read(path):
            obj = await real_read(path)
            await release.wait()
            return obj

        cluster.metadata.read = slow_read
        try:
            stale = asyncio.ensure_future(cluster.get_file_ref("obj"))
            await asyncio.sleep(0.01)
            cluster.metadata.read = real_read
            await cluster.write_file_ref("obj", ref2)
            release.set()
            await stale
        finally:
            cluster.metadata.read = real_read
        assert "obj" not in cluster._file_refs
        off = make_cluster(tmp_path)
        assert await off.get_file_ref("obj") is not \
            await off.get_file_ref("obj")
        # the LRU bound
        cluster.FILE_REF_CACHE_ENTRIES = 2
        for name in ("x", "y", "z"):
            await cluster.write_file(name, aio.BytesReader(b"q"), profile)
            await cluster.get_file_ref(name)
        assert list(cluster._file_refs) == ["y", "z"]

    arun(main())


def test_profiler_surfaces_cache_counters(tmp_path):
    payload = synthetic_bytes(2 * CHUNK_SIZE, seed=9)

    async def main():
        cluster = make_cluster(tmp_path, 64 << 20)
        await cluster.write_file("obj", aio.BytesReader(payload),
                                 cluster.get_profile(None))
        await read_all(cluster, "obj")  # fill
        ref = await cluster.get_file_ref("obj")
        profiler, reporter = new_profiler()
        cx = cluster.tunables.location_context().but_with(profiler=profiler)
        builder = cluster.file_read_builder(ref).location_context(cx)
        assert await builder.read_all() == payload
        report = reporter.profile()
        assert report.cache_stats and report.cache_stats[0].hits > 0
        assert "Cache<" in str(report)

    arun(main())


def test_tunables_cache_bytes_serde(monkeypatch):
    from chunky_bits_tpu.cluster.tunables import Tunables as JaxTunables

    monkeypatch.delenv(CACHE_BYTES_ENV, raising=False)
    monkeypatch.delenv("CHUNKY_BITS_TPU_CACHE_BYTES", raising=False)
    assert Tunables.from_obj(None).cache_bytes == 0
    t = Tunables.from_obj({"cache_bytes": 1 << 20})
    assert t.cache_bytes == 1 << 20
    assert t.to_obj()["cache_bytes"] == 1 << 20
    assert t.to_obj() == JaxTunables.from_obj({"cache_bytes": 1 << 20}) \
        .to_obj()
    assert "cache_bytes" not in Tunables.from_obj({}).to_obj()
    for bad in (-1, "lots", [1]):
        with pytest.raises(SerdeError):
            Tunables.from_obj({"cache_bytes": bad})
    monkeypatch.setenv(CACHE_BYTES_ENV, str(1 << 16))
    assert Tunables.from_obj({}).cache_bytes == 1 << 16
    assert Tunables.from_obj({"cache_bytes": 0}).cache_bytes == 0
    monkeypatch.setenv(CACHE_BYTES_ENV, "banana")
    assert Tunables.from_obj({}).cache_bytes == 0


def test_gateway_range_gets_through_cache(tmp_path):
    payload = synthetic_bytes(3 * CHUNK_SIZE + 7777, seed=21)

    async def main():
        from aiohttp.test_utils import TestClient, TestServer

        from chunky_bits_tpu_torch.gateway import make_app

        cluster = make_cluster(tmp_path, 64 << 20)
        async with TestClient(TestServer(make_app(cluster))) as client:
            assert (await client.put("/obj", data=payload)).status == 200
            ref = await cluster.get_file_ref("obj")
            chunksizes = {part.chunksize for part in ref.parts}
            for _ in range(2):
                resp = await client.get(
                    "/obj", headers={"Range": "bytes=100-4099"})
                assert resp.status == 206
                assert await resp.read() == payload[100:4100]
                lo = 2 * CHUNK_SIZE - 100
                resp = await client.get("/obj",
                                        headers={"Range": f"bytes={lo}-"})
                assert await resp.read() == payload[lo:]
                resp = await client.get("/obj")
                assert await resp.read() == payload
            cache = cluster._chunk_caches[asyncio.get_running_loop()]
            assert cache.hits > 0
            assert {len(b) for b in cache._entries.values()} <= chunksizes
        await cluster.tunables.location_context().aclose()

    arun(main())
