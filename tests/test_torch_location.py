"""The port's file-plane substrate against the JAX package: ``path``
locations, hashing, the async byte streams, the host pipeline, the
profiler and the metrics registry.

Cases carried over from ``tests/test_location.py`` and ``tests/test_hash.py``
run on both packages where both serve the scheme; the schemes the port
does not serve yet must be refused by name.  The ``http(s)://`` cases run
against ``tests/http_node.py``'s ``FakeHttpNode`` on an ephemeral port.
"""

import asyncio
import os
import threading

import numpy as np
import pytest

import chunky_bits_tpu.file.location as jlocation
from chunky_bits_tpu.file.hashing import AnyHash as JaxAnyHash
from chunky_bits_tpu_torch.errors import (LocationError, LocationParseError,
                                          SerdeError, WriteToRangeError)
from chunky_bits_tpu_torch.file import new_profiler
from chunky_bits_tpu_torch.file.hashing import AnyHash, Sha256Hash
from chunky_bits_tpu_torch.file.location import (IGNORE, Location,
                                                 LocationContext, Range,
                                                 is_publish_temp,
                                                 publish_temp_name)
from chunky_bits_tpu_torch.obs import metrics, tracing
from chunky_bits_tpu_torch.ops import backend
from chunky_bits_tpu_torch.parallel.host_pipeline import (HostPipeline,
                                                          join_jobs)
from chunky_bits_tpu_torch.utils import aio, fsio, yamlio

#: seconds a test may wait on the event loop or the host threads: a hang
#: fails the test instead of cutting the suite
TIMEOUT = 30


def bounded(fn, timeout=TIMEOUT):
    """``fn()`` on a daemon thread, failed after ``timeout`` seconds."""
    box = {}

    def target():
        try:
            box["out"] = fn()
        except BaseException as err:
            box["err"] = err

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(timeout)
    assert not thread.is_alive(), f"still running after {timeout} s"
    if "err" in box:
        raise box["err"]
    return box.get("out")


def run(coro):
    return bounded(lambda: asyncio.run(coro))


@pytest.mark.parametrize("s", ["/tmp/some/path", "relative/path",
                               "(5,10)/tmp/file", "(5,)/tmp/file",
                               "(0,0128)/tmp/file", "(x,y)/tmp/file",
                               "file:///tmp/abc"])
def test_parse_and_display_equal_jax(s):
    ours, theirs = Location.parse(s), jlocation.Location.parse(s)
    assert str(ours) == str(theirs)
    assert (ours.kind, ours.target) == (theirs.kind, theirs.target)
    assert (ours.range.start, ours.range.length, ours.range.extend_zeros) \
        == (theirs.range.start, theirs.range.length,
            theirs.range.extend_zeros)


@pytest.mark.parametrize("s", ["http://example.com/data",
                               "(7,12)https://example.com/x",
                               "slab:/store/chunk", "sim:fabric/n0/c"])
def test_schemes_not_yet_ported_are_refused(s):
    """Every scheme is ported now: ``http(s)://``, ``slab:`` and ``sim:``
    parse as the JAX package parses them."""
    ours, theirs = Location.parse(s), jlocation.Location.parse(s)
    assert (ours.kind, ours.target, str(ours)) == \
        (theirs.kind, theirs.target, str(theirs))
    assert ours.is_http() or ours.is_slab() or ours.is_sim()


def test_parse_errors_and_hierarchy():
    with pytest.raises(LocationParseError):
        Location.parse("")
    base = Location.parse("/tmp/dir")
    child = base.child("abc")
    assert str(child) == "/tmp/dir/abc"
    assert child.is_child_of(base) and base.is_parent_of(child)
    assert not Location.parse("(1,2)/tmp/dir/abc").is_child_of(base)
    assert Location.parse("(5,10)/tmp/file").range == Range(5, 10, False)


def test_fs_read_write_subfile_delete(tmp_path):
    path = tmp_path / "content"
    path.write_bytes(b"some test content")

    async def main():
        loc = Location.parse(str(path))
        assert await loc.read() == b"some test content"
        assert await loc.file_exists() and await loc.file_len() == 17
        missing = Location.parse(str(tmp_path / "missing"))
        with pytest.raises(LocationError):
            await missing.read()
        with pytest.raises(LocationError):
            await missing.file_len()
        assert not await missing.file_exists()
        base = Location.parse(str(tmp_path))
        hash_ = AnyHash.from_buf(b"shard bytes")
        child = await base.write_subfile(str(hash_), b"shard bytes")
        assert child.is_child_of(base)
        assert await child.read() == b"shard bytes"
        assert await base.write_shard(hash_, b"shard bytes") == [child]
        # the JAX package reads what the port wrote, at the same name
        assert await jlocation.Location.parse(str(child)).read() \
            == b"shard bytes"
        assert str(JaxAnyHash.from_buf(b"shard bytes")) == str(hash_)
        await child.delete()
        assert not await child.file_exists()
        with pytest.raises(LocationError):
            await child.delete()

    run(main())


def test_fs_ranges_and_conflict_policy(tmp_path):
    path = tmp_path / "ranged"
    path.write_bytes(bytes(range(100)))

    async def main():
        for rng in (Range(10, 20, False), Range(90, 20, True),
                    Range(95, None, False), Range(90, 20, False)):
            ours = await Location.local(str(path), rng).read()
            theirs = await jlocation.Location.local(
                str(path), jlocation.Range(rng.start, rng.length,
                                           rng.extend_zeros)).read()
            assert ours == theirs
        assert await Location.local(str(path), Range(90, 20, True)).read() \
            == bytes(range(90, 100)) + b"\0" * 10
        with pytest.raises(WriteToRangeError):
            await Location.local(str(path), Range(95)).write(b"x")
        loc = Location.parse(str(tmp_path / "conflict"))
        await loc.write(b"first")
        await loc.write(b"second", LocationContext(on_conflict=IGNORE))
        assert await loc.read() == b"first"
        await loc.write(b"third")
        assert await loc.read() == b"third"

    run(main())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_slab_verbs_equal_jax(tmp_path, writer):
    """Over one slab store, a chunk written through either package's
    ``slab:`` location reads the same through both: whole, ranged,
    zero-extended, viewed, its length and existence; a delete through the
    other marks it dead for both."""
    root = f"slab:{tmp_path}/store"
    data = bytes(range(256)) * 3
    wrote, other = ((Location, jlocation.Location) if writer == "port"
                    else (jlocation.Location, Location))
    ranges = ((0, None, False), (10, 20, False), (700, 100, True),
              (760, None, False), (700, 100, False))

    async def main():
        await wrote.parse(root).child("sha256-cc").write(data)
        for cls, rcls in ((Location, Range), (jlocation.Location,
                                               jlocation.Range)):
            loc = cls.parse(root).child("sha256-cc")
            assert await loc.file_exists() and await loc.file_len() == 768
            got = [await loc.with_range(rcls(*r)).read() for r in ranges]
            assert got[0] == data and got[1] == data[10:30]
            assert got[2] == data[700:] + b"\0" * 32
            assert got[3] == data[760:] and got[4] == data[700:]
            assert bytes(await loc.read_view()) == data
        await other.parse(root).child("sha256-cc").delete()
        for cls in (Location, jlocation.Location):
            assert not await cls.parse(root).child("sha256-cc").file_exists()

    run(main())


def test_streaming_reader_and_profiler_hooks(tmp_path):
    payload = os.urandom(100000)
    src = tmp_path / "src.bin"
    src.write_bytes(payload)

    async def main():
        profiler, reporter = new_profiler()
        cx = LocationContext(profiler=profiler)
        reader = await Location.parse(str(src)).reader(cx)
        total = 0
        while data := await reader.read(8192):
            total += len(data)
        await aio.close_reader(reader)
        assert total == len(payload)
        reader = await Location.parse(str(src)).reader(cx)
        assert len(await reader.read(4096)) == 4096
        await aio.close_reader(reader)
        with pytest.raises(LocationError):
            await Location.parse(str(tmp_path / "missing.bin")).reader(cx)
        await Location.parse(str(tmp_path / "dst.bin")).write(payload, cx)
        report = reporter.profile()
        reads = [e for e in report.entries if e.kind == "read"]
        writes = [e for e in report.entries if e.kind == "write"]
        assert [e.ok for e in reads] == [True, True, False]
        assert [e.length for e in reads[:2]] == [len(payload), 4096]
        assert len(writes) == 1 and writes[0].ok
        assert "ReadAvg<" in str(report)

    run(main())
    names = {f["name"] for f in metrics.get_registry().snapshot()["families"]}
    assert {"cb_io_seconds", "cb_io_bytes_total"} <= names


def test_read_view_and_atomic_publication(tmp_path, monkeypatch):
    monkeypatch.delenv("CHUNKY_BITS_TORCH_NO_MMAP", raising=False)
    data = bytes(range(256)) * 8
    path = tmp_path / "chunk"
    path.write_bytes(data)

    async def main():
        loc = Location.parse(str(path))
        assert bytes(await loc.read_view()) == data
        ranged = Location.parse(f"(64,128){path}")
        assert bytes(await ranged.read_view()) == data[64:192]
        assert await Location.parse(f"(2000,128){path}").read_view() is None
        assert await Location.parse(f"(-10,5){path}").read_view() is None
        profiler, _ = new_profiler()
        assert await loc.read_view(LocationContext(profiler=profiler)) \
            is None
        monkeypatch.setenv("CHUNKY_BITS_TORCH_NO_MMAP", "1")
        assert await loc.read_view() is None
        # the JAX package's knob does not reach the port
        monkeypatch.delenv("CHUNKY_BITS_TORCH_NO_MMAP")
        monkeypatch.setenv("CHUNKY_BITS_TPU_NO_MMAP", "1")
        view = await loc.read_view()
        assert view is not None
        assert await Location.parse(str(tmp_path / "absent")).read_view() \
            is None
        # a held view keeps the old inode's bytes across an overwrite,
        # and no temp file is left behind
        await loc.write(b"B" * 4096)
        assert bytes(view) == data
        assert await loc.read() == b"B" * 4096
        assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []
        # symlinks are written through; modes survive the replace
        real = tmp_path / "real.bin"
        real.write_bytes(b"old")
        link = tmp_path / "link.bin"
        link.symlink_to(real)
        await Location.parse(str(link)).write(b"through-the-link")
        assert link.is_symlink() and real.read_bytes() == b"through-the-link"
        os.chmod(path, 0o600)
        await loc.write(b"v2")
        assert os.stat(path).st_mode & 0o777 == 0o600

    run(main())
    assert is_publish_temp(publish_temp_name("/x/chunk"))
    assert not is_publish_temp("/x/chunk")


def test_failed_publication_leaves_the_old_content(tmp_path):
    path = tmp_path / "out.bin"
    path.write_bytes(b"previous")
    faulty = fsio.FaultyFsProvider("replace")
    previous = fsio.install(faulty)
    try:
        with pytest.raises(LocationError, match="injected"):
            run(Location.parse(str(path)).write(b"new"))
    finally:
        fsio.install(previous)
    assert faulty.fired == 1
    assert path.read_bytes() == b"previous"
    assert [f for f in os.listdir(tmp_path) if ".tmp." in f] == []


def test_hashing_known_answers_equal_jax():
    h = Sha256Hash.from_buf(b"hello world")
    assert h.hex() == (
        "b94d27b9934d3e08a52e52d7da7dabfac484efe37a5380ee9088f7ace2efcde9")
    assert h.verify(b"hello world") and not h.verify(b"hello worlD")
    any_hash = AnyHash.from_buf(b"data")
    assert str(any_hash) == str(JaxAnyHash.from_buf(b"data"))
    assert AnyHash.parse(str(any_hash)) == any_hash
    for bad in ("md5-abcdef", "nodash", "sha256-zz"):
        with pytest.raises(SerdeError):
            AnyHash.parse(bad)

    async def main():
        h = AnyHash.from_buf(b"stream me")
        assert await h.verify_async(b"stream me")
        assert not await h.verify_async(b"other")
        assert await h.rehash_async(b"x") == AnyHash.from_buf(b"x")

    run(main())


def test_byte_streams():
    async def main():
        mem = bytearray(10)
        got = await aio.read_exact_into(aio.BytesReader(b"abcdef"),
                                        memoryview(mem))
        assert got == 6 and bytes(mem[:6]) == b"abcdef"

        async def chunks():
            for c in (b"ab", b"cdef", b"g"):
                yield c

        reader = aio.IterReader(chunks())
        assert bytes(await reader.read(3)) == b"ab"
        assert bytes(await reader.read(3)) == b"cde"
        assert await reader.read(-1) == b"fg"
        take = aio.TakeReader(aio.BytesReader(b"0123456789"), 4)
        assert await take.read(-1) == b"0123" and await take.read() == b""
        zeros = aio.ZeroExtendReader(aio.BytesReader(b"ab"), 5)
        assert await zeros.read(5) == b"ab"
        assert await zeros.read(5) == b"\0\0\0"

        async def boom():
            raise ValueError("first")

        slow = asyncio.ensure_future(asyncio.sleep(10))
        with pytest.raises(ValueError, match="first"):
            await aio.gather_or_cancel([boom(), slow])
        assert slow.cancelled()

    run(main())


def test_view_parts_hands_out_read_only_whole_parts(tmp_path):
    path = tmp_path / "src.bin"
    path.write_bytes(bytes(range(256)) * 10)  # 2560 bytes

    async def main():
        reader = aio.FileReader(str(path))
        try:
            view = await reader.view_parts(1000, 4)
            assert view.readonly and len(view) == 2000
            assert await reader.view_parts(1000, 4) is None
            rest = bytearray(1000)
            assert await aio.read_exact_into(reader, memoryview(rest)) == 560
            tensor = backend.as_tensor(np.frombuffer(view, dtype=np.uint8))
            assert bytes(tensor.numpy()) == (bytes(range(256)) * 10)[:2000]
        finally:
            await reader.close()

    run(main())


def test_host_pipeline_runs_and_counts(monkeypatch):
    monkeypatch.delenv("CHUNKY_BITS_TORCH_HOST_THREADS", raising=False)
    pipeline = HostPipeline(threads=2)
    rows = np.random.default_rng(1).integers(0, 256, (5, 3, 64),
                                             dtype=np.uint8)
    coder = backend.ErasureCoder(3, 2, backend.NumpyBackend())

    def sync_calls():
        out = np.empty((5, 3, 32), dtype=np.uint8)
        join_jobs(pipeline.hash_rows_jobs(rows, out))
        return out, pipeline.encode_hash_sync(coder, rows)

    async def traced():
        trace, token = tracing.start("t1")
        try:
            assert await pipeline.run("x", lambda: 7) == 7
            with pytest.raises(KeyError):
                await pipeline.run("x", lambda: {}["k"])
        finally:
            tracing.finish(trace, token, duration=1.0, slow_s=0.0, meta={})
        return trace

    try:
        assert pipeline in metrics.get_registry().sources("pipeline")
        out, (parity, digests) = bounded(sync_calls)
        want = np.empty_like(out)
        backend.row_hasher()(rows, want)
        assert np.array_equal(out, want)
        want_parity, want_digests = coder.encode_hash_batch(rows)
        assert np.array_equal(parity, want_parity)
        assert np.array_equal(digests, want_digests)
        trace = run(traced())
        assert {s.name for s in trace.spans} >= {"queue.x", "pipeline.x"}
        stages = {s.stage: s.jobs for s in pipeline.stats().stages}
        assert stages["x"] == 2 and stages["hash"] >= 2
    finally:
        bounded(pipeline.close)
    monkeypatch.setenv("CHUNKY_BITS_TORCH_HOST_THREADS", "1")
    single = HostPipeline()
    bounded(single.close)
    assert single.threads == 1


def test_yaml_round_trip_matches_safe_dump():
    import yaml

    obj = {"length": 3, "parts": [{"chunksize": 1, "data": []}]}
    assert yamlio.yaml_dump(obj, sort_keys=False) \
        == yaml.safe_dump(obj, sort_keys=False)
    assert yamlio.yaml_load(yamlio.yaml_dump(obj)) == obj


# ---- the http(s):// scheme, against tests/http_node.py ----

class RecordingNode:
    """A ``FakeHttpNode`` that records each GET's User-Agent and can
    answer the next GETs with a transient status."""

    @staticmethod
    async def start(get_fail_status=0, get_fail_remaining=0):
        from tests.http_node import FakeHttpNode

        node = FakeHttpNode()
        node.agents = []
        node.get_fail = [get_fail_status, get_fail_remaining]
        plain_get = node._get

        async def _get(request):
            from aiohttp import web

            node.agents.append(request.headers.get("User-Agent"))
            if node.get_fail[1] > 0:
                node.get_fail[1] -= 1
                return web.Response(status=node.get_fail[0])
            return await plain_get(request)

        node._get = _get
        return await node.start()


def test_http_full_cycle():
    from chunky_bits_tpu_torch.errors import HttpStatusError

    async def main():
        node = await RecordingNode.start()
        cx = LocationContext()
        try:
            base = Location.parse(node.url + "/data")
            hash_ = AnyHash.from_buf(b"http shard")
            child = await base.write_subfile(str(hash_), b"http shard", cx)
            assert child.is_child_of(base) and base.is_parent_of(child)
            assert str(child) == str(jlocation.Location.parse(
                node.url + "/data").child(str(hash_)))
            assert await child.read(cx) == b"http shard"
            assert await child.file_exists(cx)
            assert await child.file_len(cx) == len(b"http shard")
            icx = cx.but_with(on_conflict=IGNORE)
            await child.write(b"changed", icx)
            assert await child.read(cx) == b"http shard"
            await child.write(b"changed", cx)
            assert await child.read(cx) == b"changed"
            assert await child.with_range(Range(2, 3, False)).read(cx) \
                == b"ang"
            assert await child.with_range(Range(4, None, False)).read(cx) \
                == b"ged"
            assert await child.with_range(Range(5, 4, True)).read(cx) \
                == b"ed\0\0"
            reader = await child.reader(cx)
            assert await reader.read(3) == b"cha"
            await aio.close_reader(reader)
            await child.delete(cx)
            with pytest.raises(HttpStatusError):
                await child.read(cx)
            assert not await child.file_exists(cx)
            with pytest.raises(HttpStatusError):
                await child.file_len(cx)
            dloc = Location.parse(node.url + "/streamed")
            n = await dloc.write_from_reader(
                aio.BytesReader(b"x" * 100000), cx)
            assert n == 100000 and node.store["streamed"] == b"x" * 100000
            assert await dloc.read_view(cx) is None  # local only
            with pytest.raises(HttpStatusError):
                await Location.parse(node.url + "/fail/x").write(b"d", cx)
            with pytest.raises(HttpStatusError):
                await Location.parse(node.url + "/fail/y") \
                    .write_from_reader(aio.BytesReader(b"d"), cx)
            # redirects are followed without https_only
            assert await Location.parse(node.url + "/redir/streamed") \
                .read(cx) == b"x" * 100000
        finally:
            await cx.aclose()
            await node.stop()

    run(main())


def test_https_only_refuses_plain_http_and_redirects():
    from types import SimpleNamespace
    from urllib.parse import urlsplit

    async def main():
        node = await RecordingNode.start()
        open_cx = LocationContext()
        cx = LocationContext(https_only=True)
        try:
            loc = Location.parse(node.url + "/sec")
            await loc.write(b"payload", open_cx)
            for op in (loc.read(cx), loc.reader(cx), loc.write(b"x", cx),
                       loc.write_from_reader(aio.BytesReader(b"x"), cx),
                       loc.delete(cx), loc.file_exists(cx),
                       loc.file_len(cx)):
                with pytest.raises(LocationError, match="https_only"):
                    await op
            assert await loc.read(open_cx) == b"payload"
        finally:
            await open_cx.aclose()
            await node.stop()

    run(main())

    class StubUrl:
        def __init__(self, url):
            self.scheme = urlsplit(url).scheme
            self._url = url

        def __str__(self):
            return self._url

    def resp(status, url, history=()):
        return SimpleNamespace(
            status=status, url=StubUrl(url), release=lambda: None,
            history=tuple(SimpleNamespace(url=StubUrl(u))
                          for u in history))

    cx = LocationContext(https_only=True)
    loc = Location.http("https://node.example/chunk")
    with pytest.raises(LocationError, match="refusing redirect"):
        loc._check_redirect(cx, resp(302, "https://node.example/chunk"))
    with pytest.raises(LocationError, match="plain http"):
        loc._check_response_hops(cx, resp(
            200, "http://node.example/chunk",
            history=["https://node.example/chunk"]))
    loc._check_response_hops(cx, resp(
        200, "https://n2.example/chunk",
        history=["https://node.example/chunk"]))
    loc._check_redirect(LocationContext(),
                        resp(302, "https://node.example/chunk"))
    with pytest.raises(LocationParseError):
        Location.http("/not/a/url")
    with pytest.raises(LocationParseError):
        Location.parse("http:///no-host")


def test_user_agent_rides_every_request():
    async def main():
        node = await RecordingNode.start()
        cx = LocationContext(user_agent="chunky-bits-test/1")
        plain = LocationContext()
        try:
            loc = Location.parse(node.url + "/ua")
            await loc.write(b"ua", cx)
            assert await loc.read(cx) == b"ua"
            assert await loc.read(plain) == b"ua"
            assert node.agents[0] == "chunky-bits-test/1"
            assert node.agents[1] != "chunky-bits-test/1"
            # one session per loop, shared by but_with copies
            assert cx.http_session() is cx.but_with(
                on_conflict=IGNORE).http_session()
        finally:
            await cx.aclose()
            await plain.aclose()
            await node.stop()

    run(main())


@pytest.mark.parametrize("status,retried", [(503, True), (429, True),
                                            (404, False)])
def test_transient_http_statuses_are_retried(tmp_path, status, retried):
    """A part read over http retries a transient status on the same
    location (``read_retries``) and falls through on any other; a shard
    PUT answered 503 once lands on its retry."""
    from chunky_bits_tpu_torch.cluster.destination import (ClusterWriter,
                                                           _WriterState)
    from chunky_bits_tpu_torch.cluster.nodes import ClusterNodes
    from chunky_bits_tpu_torch.cluster.profile import ClusterProfile
    from chunky_bits_tpu_torch.file.chunk import Chunk
    from chunky_bits_tpu_torch.file.file_part import FilePart

    payload = np.random.default_rng(4).integers(
        0, 256, 4096, dtype=np.uint8).tobytes()

    async def main():
        node = await RecordingNode.start(status, 1)
        cx = LocationContext(read_retries=1)
        try:
            node.put_fail_status, node.put_fail_remaining = 503, 1
            nodes = ClusterNodes.from_obj([{"location": node.url + "/"}])
            writer = ClusterWriter(_WriterState(
                nodes, ClusterProfile.from_obj({"data": 1, "parity": 0}),
                cx), None, None)
            hash_ = AnyHash.from_buf(payload)
            locations = await writer.write_shard(hash_, payload)
            assert node.put_attempts == 2 and len(locations) == 1
            local = tmp_path / "replica"
            local.write_bytes(payload)
            part = FilePart(chunksize=len(payload), data=[Chunk(
                hash_, [locations[0], Location.local(str(local))])],
                parity=[])
            got = await part.read(cx, backend="torch")
            assert got == payload
            # the remote served the retry, or the local replica served
            # the fall-through
            assert len(node.agents) == (2 if retried else 1)
        finally:
            await cx.aclose()
            await node.stop()

    run(main())


def test_cluster_over_http_nodes_both_packages(tmp_path):
    """A cluster of FakeHttpNode destinations written by one package reads
    back byte-identical through the other, degraded reads included."""
    from chunky_bits_tpu.cluster import Cluster as JaxCluster
    from chunky_bits_tpu.utils import aio as jaio
    from chunky_bits_tpu_torch.cluster import Cluster

    payload = np.random.default_rng(5).integers(
        0, 256, 3 * (3 << 12) + 777, dtype=np.uint8).tobytes()

    async def main():
        from tests.http_node import FakeHttpNode

        nodes = [await FakeHttpNode().start() for _ in range(5)]
        meta = tmp_path / "meta"
        meta.mkdir()
        spec = {"destinations": [{"location": n.url + f"/d{i}/"}
                                 for i, n in enumerate(nodes)],
                "metadata": {"type": "path", "format": "yaml",
                             "path": str(meta)},
                "profiles": {"default": {"data": 3, "parity": 2,
                                         "chunk_size": 12}},
                "tunables": {"backend": "numpy"}}
        ours, theirs = Cluster.from_obj(spec), JaxCluster.from_obj(spec)
        try:
            await ours.write_file("by-port", aio.BytesReader(payload),
                                  ours.get_profile(None))
            await theirs.write_file("by-jax", jaio.BytesReader(payload),
                                    theirs.get_profile(None))
            assert await ours.metadata.read("by-port") == \
                await theirs.metadata.read("by-jax")
            for reader, name in ((theirs, "by-port"), (ours, "by-jax")):
                ref = await reader.get_file_ref(name)
                got = await reader.file_read_builder(ref).read_all()
                assert got == payload
            # lose two chunks of every part: the port rebuilds them
            ref = await ours.get_file_ref("by-jax")
            cx = ours.tunables.location_context()
            for part in ref.parts:
                for chunk in (part.data[0], part.parity[1]):
                    await chunk.locations[0].delete(cx)
            got = await ours.file_read_builder(ref).read_all()
            assert got == payload
        finally:
            await ours.tunables.location_context().aclose()
            await theirs.tunables.location_context().aclose()
            for n in nodes:
                await n.stop()

    run(main())
