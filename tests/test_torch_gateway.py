"""The port's HTTP gateway (``chunky_bits_tpu_torch.gateway``), held
against the assertions of ``tests/test_gateway.py`` and
``tests/test_gateway_scaleout.py``, and against the JAX package's gateway.

Clusters run the ``torch`` backend over temporary ``path`` destinations
(d=3 p=2, 64 KiB chunks).  Every test runs its event loop under a
deadline (``arun``), so a hang fails one test instead of cutting the
suite.  The cross-package test sends one list of raw HTTP/1.1 requests
to a JAX gateway (``numpy`` backend) and to the port's (``torch``), each
with its own ``Cluster`` over one tree, and compares status, headers and
bodies byte for byte; objects PUT through either read back through the
other package's cluster.  One test spawns the ``--workers 2`` fleet
through the CLI (each worker pays a torch import).
"""

import asyncio
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import yaml

from chunky_bits_tpu_torch.cluster import Cluster
from chunky_bits_tpu_torch.cluster import tunables
from chunky_bits_tpu_torch.file.file_reference import FileReference
from chunky_bits_tpu_torch.file.location import Location
from chunky_bits_tpu_torch.file.profiler import request_stats
from chunky_bits_tpu_torch.file.reader import FileReadBuilder
from chunky_bits_tpu_torch.gateway import (file_ref_etag, make_app,
                                           parse_http_range)
from chunky_bits_tpu_torch.gateway import http as gw
from chunky_bits_tpu_torch.gateway.http import PROFILER_KEY, HttpRangeError
from chunky_bits_tpu_torch.obs import metrics as obs_metrics
from tests.gateway_probe import leave_after_last_sendfile_byte

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: seconds a test's event loop may run before the test fails
TIMEOUT = 60

CHUNK = 1 << 16


def arun(coro, timeout=TIMEOUT):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def cluster_spec(tmp_path, backend="torch", cache_bytes=0) -> dict:
    dirs = []
    for i in range(5):
        d = tmp_path / f"disk{i}"
        d.mkdir(exist_ok=True)
        dirs.append(str(d))
    meta = tmp_path / "meta"
    meta.mkdir(exist_ok=True)
    tun = {"backend": backend}
    if cache_bytes:
        tun["cache_bytes"] = cache_bytes
    return {
        "destinations": [{"location": d} for d in dirs],
        "metadata": {"type": "path", "format": "yaml", "path": str(meta)},
        "profiles": {"default": {"data": 3, "parity": 2,
                                 "chunk_size": 16}},
        "tunables": tun,
    }


def make_cluster(tmp_path, **kwargs) -> Cluster:
    return Cluster.from_obj(cluster_spec(tmp_path, **kwargs))


def payload_of(n, seed=7) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


async def served(app):
    from aiohttp.test_utils import TestClient, TestServer

    return TestClient(TestServer(app))


# ---- parsing ----

def test_parse_http_range():
    assert parse_http_range("bytes=0-99") == ("range", 0, 99)
    assert parse_http_range("bytes=500-") == ("prefix", 500)
    assert parse_http_range("bytes=-300") == ("suffix", 300)
    for bad in ("bytes=5-2", "chars=0-5", "bytes=0-5,10-20", "bytes=-",
                "bytes=a-b", "garbage"):
        with pytest.raises(HttpRangeError):
            parse_http_range(bad)


def test_gateway_workers_tunable(monkeypatch):
    monkeypatch.delenv(tunables.GATEWAY_WORKERS_ENV, raising=False)
    assert tunables.gateway_workers() == 1
    for raw, want in (("4", 4), ("0", 1), ("-2", 1), ("junk", 1),
                      ("", 1)):
        monkeypatch.setenv(tunables.GATEWAY_WORKERS_ENV, raw)
        assert tunables.gateway_workers() == want, raw
    monkeypatch.delenv(tunables.GATEWAY_WORKERS_ENV)
    monkeypatch.delenv(tunables.GATEWAY_SENDFILE_ENV, raising=False)
    assert tunables.gateway_sendfile() is True
    monkeypatch.setenv(tunables.GATEWAY_SENDFILE_ENV, "0")
    assert tunables.gateway_sendfile() is False
    # the JAX package's knobs never reach the port
    monkeypatch.delenv(tunables.GATEWAY_SENDFILE_ENV)
    monkeypatch.setenv("CHUNKY_BITS_TPU_GATEWAY_WORKERS", "3")
    monkeypatch.setenv("CHUNKY_BITS_TPU_GATEWAY_SENDFILE", "0")
    assert tunables.gateway_workers() == 1
    assert tunables.gateway_sendfile() is True


# ---- GET, HEAD, ranges, PUT ----

def test_gateway_end_to_end(tmp_path):
    payload = payload_of(300000)

    async def main():
        cluster = make_cluster(tmp_path)
        async with await served(make_app(cluster)) as client:
            resp = await client.put(
                "/objects/data.bin", data=payload,
                headers={"Content-Type": "application/x-demo"})
            assert resp.status == 200
            meta = await cluster.metadata.read("objects/data.bin")
            assert meta["content_type"] == "application/x-demo"
            resp = await client.get("/objects/data.bin")
            assert resp.status == 200
            assert resp.headers["Content-Type"] == "application/x-demo"
            assert await resp.read() == payload
            resp = await client.head("/objects/data.bin")
            assert resp.status == 200
            assert int(resp.headers["Content-Length"]) == len(payload)
            resp = await client.get(
                "/objects/data.bin", headers={"Range": "bytes=100-199"})
            assert resp.status == 206
            assert await resp.read() == payload[100:200]
            assert resp.headers["Content-Range"] == \
                f"bytes 100-199/{len(payload)}"
            resp = await client.get(
                "/objects/data.bin",
                headers={"Range": f"bytes={len(payload) - 50}-"})
            assert resp.status == 206
            assert await resp.read() == payload[-50:]
            resp = await client.get(
                "/objects/data.bin", headers={"Range": "bytes=-77"})
            assert resp.status == 206
            assert await resp.read() == payload[-77:]
            # an oversized suffix selects the whole representation
            resp = await client.get(
                "/objects/data.bin",
                headers={"Range": f"bytes=-{len(payload) + 10}"})
            assert resp.status == 206
            assert await resp.read() == payload
            for header in ("bytes=0-5,10-20", "chars=0-5", "garbage"):
                resp = await client.get(
                    "/objects/data.bin", headers={"Range": header})
                assert resp.status == 200, header
                assert await resp.read() == payload
            assert (await client.get("/missing")).status == 404
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_416_carries_content_range(tmp_path):
    payload = payload_of(50000)

    async def main():
        cluster = make_cluster(tmp_path)
        async with await served(make_app(cluster)) as client:
            assert (await client.put("/o", data=payload)).status == 200
            for header in (f"bytes={len(payload)}-",
                           f"bytes={len(payload) + 10}-"
                           f"{len(payload) + 20}"):
                resp = await client.get("/o", headers={"Range": header})
                assert resp.status == 416, header
                assert resp.headers["Content-Range"] == \
                    f"bytes */{len(payload)}"
            resp = await client.get("/o", headers={"Range": "garbage"})
            assert resp.status == 200
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_etag_and_conditional_get(tmp_path):
    """ETag on GET/HEAD; If-None-Match (exact, W/, list, *) answers 304
    with no body, before Range; placement does not change the tag; a
    re-PUT does."""
    payload = payload_of(100000)

    async def main():
        cluster = make_cluster(tmp_path)
        async with await served(make_app(cluster)) as client:
            assert (await client.put("/obj", data=payload)).status == 200
            resp = await client.get("/obj")
            etag = resp.headers["ETag"]
            assert etag.startswith('"') and etag.endswith('"')
            assert await resp.read() == payload
            ref = await cluster.get_file_ref("obj")
            assert etag == file_ref_etag(ref)
            resp = await client.head("/obj")
            assert resp.headers["ETag"] == etag
            for header in (etag, f"W/{etag}", f'"nope", {etag}', "*"):
                resp = await client.get(
                    "/obj", headers={"If-None-Match": header})
                assert resp.status == 304, header
                assert resp.headers["ETag"] == etag
                assert await resp.read() == b""
            resp = await client.get(
                "/obj", headers={"If-None-Match": '"deadbeef"'})
            assert resp.status == 200
            assert await resp.read() == payload
            resp = await client.get(
                "/obj", headers={"If-None-Match": etag,
                                 "Range": "bytes=0-99"})
            assert resp.status == 304
            moved = FileReference.from_obj(ref.to_obj())
            moved.parts[0].data[0].locations.append(
                Location.local(str(tmp_path / "disk0-replica")))
            assert file_ref_etag(moved) == etag
            assert (await client.put(
                "/obj", data=payload_of(100000, seed=8))).status == 200
            resp = await client.get("/obj", headers={"If-None-Match": etag})
            assert resp.status == 200
            assert resp.headers["ETag"] != etag
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_etag_equals_the_jax_gateways(tmp_path):
    from chunky_bits_tpu.file.file_reference import \
        FileReference as JaxFileReference
    from chunky_bits_tpu.gateway import file_ref_etag as jax_etag

    async def main():
        cluster = make_cluster(tmp_path)
        async with await served(make_app(cluster)) as client:
            for i, n in enumerate((0, 1, 3 * CHUNK, 5 * CHUNK + 777)):
                assert (await client.put(f"/o{i}",
                                         data=payload_of(n))).status == 200
                obj = await cluster.metadata.read(f"o{i}")
                assert file_ref_etag(FileReference.from_obj(obj)) == \
                    jax_etag(JaxFileReference.from_obj(obj))
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_put_limits_and_errors(tmp_path):
    from chunky_bits_tpu_torch.errors import MetadataReadError

    async def main():
        cluster = make_cluster(tmp_path)
        app = make_app(cluster, max_put_bytes=100000, max_concurrent_puts=4)
        async with await served(app) as client:
            resp = await client.put("/big", data=b"x" * 200000)
            assert resp.status == 413

            async def gen():
                for _ in range(30):
                    yield b"y" * 10000
            resp = await client.put("/big2", data=gen())
            assert resp.status == 413
            assert "too large" in await resp.text()
            assert (await client.put("/ok", data=b"z" * 50000)).status \
                == 200
            for rejected in ("big", "big2"):
                with pytest.raises(MetadataReadError):
                    await cluster.metadata.read(rejected)
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_put_concurrency_bound(tmp_path, monkeypatch):
    async def main():
        cluster = make_cluster(tmp_path)
        in_flight = {"now": 0, "peak": 0}
        real_write = Cluster.write_file

        async def counting_write(self, path, reader, profile,
                                 content_type=None):
            in_flight["now"] += 1
            in_flight["peak"] = max(in_flight["peak"], in_flight["now"])
            try:
                await asyncio.sleep(0.01)
                return await real_write(self, path, reader, profile,
                                        content_type)
            finally:
                in_flight["now"] -= 1

        monkeypatch.setattr(Cluster, "write_file", counting_write)
        async with await served(make_app(
                cluster, max_concurrent_puts=3)) as client:
            resps = await asyncio.gather(*[
                client.put(f"/obj{i}", data=payload_of(20000, seed=i))
                for i in range(12)])
            assert all(r.status == 200 for r in resps)
        assert 1 < in_flight["peak"] <= 3
        await cluster.tunables.location_context().aclose()

    arun(main())


@pytest.mark.parametrize("clock_case", ["grace", "silent", "burst"])
def test_guarded_body_rate_floor(monkeypatch, clock_case):
    """The minimum-rate guard: a trickle past the grace window, a client
    that sends nothing, and a burst followed by a stall are all
    aborted; ``min_rate=0`` disables the floor."""

    class Trickle:
        async def read(self, n=-1):
            return b"z"

    class Silent:
        async def read(self, n=-1):
            await asyncio.Future()  # never resolves

    async def main():
        if clock_case == "grace":
            clock = {"now": 0.0}
            monkeypatch.setattr(gw.time, "monotonic",
                                lambda: clock["now"])
            body = gw._GuardedBody(Trickle(), max_bytes=None, min_rate=256)
            clock["now"] = gw._RATE_GRACE_SECONDS - 1
            assert await body.read(1024) == b"z"
            clock["now"] = gw._RATE_GRACE_SECONDS + 10
            with pytest.raises(gw._BodyTooSlow):
                await body.read(1024)
            fast = gw._GuardedBody(Trickle(), max_bytes=None, min_rate=0)
            clock["now"] = 10_000.0
            assert await fast.read(1024) == b"z"
            return
        monkeypatch.setattr(gw, "_RATE_GRACE_SECONDS", 0.05)
        body = gw._GuardedBody(Silent(), max_bytes=None,
                               min_rate=256 if clock_case == "silent"
                               else 1)
        if clock_case == "burst":
            body.total = 10 ** 9  # credit banked by a line-speed burst
        with pytest.raises(gw._BodyTooSlow):
            await body.read(1024)

    arun(main())


# ---- the serve path: sendfile, degraded reads, admission ----

@pytest.mark.parametrize("writer", ["torch", "numpy"])
def test_sendfile_vs_reassembly_byte_identity(tmp_path, writer):
    """Every byte off the sendfile path equals the reassembly path's and
    the payload: whole objects, ranges inside one chunk, exactly one
    chunk, suffixes and the padded tail chunk, for objects written by
    the port's ``torch`` and ``numpy`` backends."""
    payload = payload_of(3 * CHUNK + 12345)
    ranges = [None, "bytes=100-199", "bytes=0-65535", "bytes=70000-80000",
              f"bytes={len(payload) - 50}-", "bytes=-77"]

    async def main():
        cluster = make_cluster(tmp_path, backend=writer)
        app_sf = make_app(cluster, sendfile=True)
        app_plain = make_app(cluster, sendfile=False)
        got_sf = {}
        async with await served(app_sf) as client:
            assert (await client.put("/obj", data=payload)).status == 200
            for rng in ranges:
                resp = await client.get(
                    "/obj", headers={"Range": rng} if rng else {})
                assert resp.status in (200, 206)
                got_sf[rng] = await resp.read()
            sources = [e.source for e in
                       app_sf[PROFILER_KEY].drain_requests()
                       if e.method == "GET"]
            assert sources.count("sendfile") >= 3, sources
        async with await served(app_plain) as client:
            for rng in ranges:
                resp = await client.get(
                    "/obj", headers={"Range": rng} if rng else {})
                assert await resp.read() == got_sf[rng], rng
            assert not any(e.source == "sendfile" for e in
                           app_plain[PROFILER_KEY].drain_requests())
        assert got_sf[None] == payload
        assert got_sf["bytes=100-199"] == payload[100:200]
        assert got_sf["bytes=0-65535"] == payload[:CHUNK]
        assert got_sf["bytes=70000-80000"] == payload[70000:80001]
        assert got_sf[f"bytes={len(payload) - 50}-"] == payload[-50:]
        assert got_sf["bytes=-77"] == payload[-77:]
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_sendfile_corrupt_local_chunk_falls_back(tmp_path):
    payload = payload_of(200000)

    async def main():
        cluster = make_cluster(tmp_path)
        app = make_app(cluster, sendfile=True)
        async with await served(app) as client:
            assert (await client.put("/obj", data=payload)).status == 200
            ref = await cluster.get_file_ref("obj")
            victim = ref.parts[0].data[0].locations[0].target
            with open(victim, "rb") as f:
                blob = bytearray(f.read())
            blob[0] ^= 0xFF
            with open(victim, "wb") as f:
                f.write(blob)
            resp = await client.get("/obj",
                                    headers={"Range": "bytes=0-999"})
            assert resp.status == 206
            assert await resp.read() == payload[:1000]
            assert not any(e.source == "sendfile" for e in
                           app[PROFILER_KEY].drain_requests()
                           if e.method == "GET")
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_sendfile_closes_its_file_when_its_client_leaves(tmp_path,
                                                         monkeypatch):
    """A client that leaves right after the last byte of a sendfile GET
    finds the handler's chunk file closed: the port closes it inline,
    with no thread hop left to cancel.  The JAX gateway closes it with a
    cancellable thread hop, and would leave it open here (ROADMAP.md
    Queue C, its sendfile item)."""
    cluster = make_cluster(tmp_path)

    async def main():
        files = await leave_after_last_sendfile_byte(
            make_app(cluster, sendfile=True), monkeypatch)
        await cluster.tunables.location_context().aclose()
        return files

    files = arun(main())
    try:
        assert all(f.closed for f in files)
    finally:
        for f in files:
            f.close()


def test_degraded_get_and_abort_beyond_repair(tmp_path, caplog):
    """A GET rebuilds around a deleted chunk; with every chunk of a later
    part gone the connection aborts (never a clean short 200), a range
    inside an intact part still answers, and the server survives."""
    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    part_bytes = 3 * CHUNK
    payload = payload_of(3 * part_bytes + 5000)

    async def main():
        cluster = make_cluster(tmp_path)
        async with TestClient(
                TestServer(make_app(cluster)),
                connector=aiohttp.TCPConnector(force_close=True)) as client:
            assert (await client.put("/obj/x", data=payload)).status == 200
            ref = await cluster.get_file_ref("obj/x")
            os.remove(ref.parts[0].data[0].locations[0].target)
            resp = await client.get("/obj/x")
            assert await resp.read() == payload
            for chunk in ref.parts[1].all_chunks():
                os.remove(chunk.locations[0].target)
            with pytest.raises(aiohttp.ClientError):
                resp = await client.get("/obj/x")
                assert resp.status == 200
                body = await resp.read()
                assert len(body) < len(payload)
                raise aiohttp.ClientPayloadError("short body")
            with caplog.at_level("ERROR", "chunky_bits_tpu_torch.gateway"):
                caplog.clear()
                resp = await client.get(
                    "/obj/x", headers={"Range": "bytes=0-999"})
                assert resp.status == 206
                assert await resp.read() == payload[:1000]
                assert not [r for r in caplog.records
                            if "aborted mid-stream" in r.message]
            assert (await client.put("/obj/y",
                                     data=b"still alive")).status == 200
            resp = await client.get("/obj/y")
            assert await resp.read() == b"still alive"
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_admission_control_sheds_excess_gets(tmp_path, monkeypatch):
    """Past ``max_concurrent_gets`` bodies in flight a GET gets 503 +
    Retry-After; HEAD and 304 still answer; slots free and reads are
    admitted again."""
    payload = payload_of(30000)

    async def main():
        cluster = make_cluster(tmp_path)
        gate = asyncio.Event()
        real_stream = FileReadBuilder.stream

        async def slow_stream(self):
            await asyncio.wait_for(gate.wait(), timeout=10)
            async for chunk in real_stream(self):
                yield chunk

        async with await served(make_app(
                cluster, max_concurrent_gets=2)) as client:
            assert (await client.put("/obj", data=payload)).status == 200
            resp = await client.get("/obj")
            etag = resp.headers["ETag"]
            assert await resp.read() == payload
            monkeypatch.setattr(FileReadBuilder, "stream", slow_stream)
            holders = [asyncio.ensure_future(client.get("/obj"))
                       for _ in range(2)]
            await asyncio.sleep(0.1)
            shed = await client.get("/obj")
            assert shed.status == 503
            assert shed.headers["Retry-After"] == "1"
            assert "too many" in await shed.text()
            assert (await client.head("/obj")).status == 200
            resp = await client.get("/obj", headers={"If-None-Match": etag})
            assert resp.status == 304
            gate.set()
            for r in await asyncio.gather(*holders):
                assert r.status == 200
                assert await r.read() == payload
            monkeypatch.setattr(FileReadBuilder, "stream", real_stream)
            resp = await client.get("/obj")
            assert await resp.read() == payload
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_keepalive_clients_and_cache(tmp_path):
    """Concurrent keep-alive clients with full, ranged and conditional
    GETs against one app with the read cache on: every byte right, the
    hot object served from the cache."""
    import aiohttp
    from aiohttp.test_utils import TestClient, TestServer

    payload = payload_of(150000)
    n_clients = 50

    async def main():
        cluster = make_cluster(tmp_path, cache_bytes=8 << 20)
        app = make_app(cluster)
        async with TestClient(TestServer(app), connector=aiohttp.TCPConnector(
                limit=n_clients)) as client:
            assert (await client.put("/hot", data=payload)).status == 200
            resp = await client.get("/hot")
            etag = resp.headers["ETag"]
            assert await resp.read() == payload

            async def one_client(i):
                r = await client.get("/hot")
                assert await r.read() == payload
                start = (i * 613) % (len(payload) - 1000)
                r = await client.get(
                    "/hot", headers={"Range": f"bytes={start}-{start + 999}"})
                assert r.status == 206
                assert await r.read() == payload[start:start + 1000]
                r = await client.get("/hot", headers={"If-None-Match": etag})
                assert r.status == 304

            await asyncio.gather(*[one_client(i) for i in range(n_clients)])
            gets = [e for e in app[PROFILER_KEY].drain_requests()
                    if e.method == "GET"]
            assert sum(1 for e in gets if e.source == "cond") >= n_clients
            assert any(e.source == "cache" for e in gets)
            cache = cluster._chunk_cache()
            assert cache is not None and cache.hits > 0
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_access_log_line_and_stats(tmp_path, caplog):
    payload = payload_of(20000)

    async def main():
        cluster = make_cluster(tmp_path)
        app = make_app(cluster)
        async with await served(app) as client:
            with caplog.at_level("INFO", "chunky_bits_tpu_torch.gateway"):
                assert (await client.put("/a", data=payload)).status == 200
                await (await client.get("/a")).read()
                assert (await client.get("/missing")).status == 404
                assert (await client.post("/a", data=b"x")).status == 405
        await cluster.tunables.location_context().aclose()
        return app

    app = arun(main())
    lines = [r.message for r in caplog.records
             if r.message.startswith("req ")]
    assert any("method=PUT" in ln and "status=200" in ln for ln in lines)
    assert any("method=GET" in ln and f"bytes={len(payload)}" in ln
               and "source=store" in ln for ln in lines)
    assert any("status=404" in ln for ln in lines)
    assert any("method=POST" in ln and "status=405" in ln for ln in lines)
    assert not any("status=500" in ln for ln in lines)
    entries = app[PROFILER_KEY].drain_requests()
    stats = request_stats(entries)
    assert (stats.count, stats.errors, stats.total_bytes) == \
        (4, 0, len(payload))
    assert stats.p50_ms <= stats.p99_ms <= stats.p999_ms


def test_observability_endpoints(tmp_path):
    """``/metrics`` parses with the port's grammar check and the JAX
    package's; ``/stats``, ``/healthz``, ``/debug/traces``,
    ``/scrub/status`` and ``/alerts`` answer as the JAX gateway does with
    scrub and the SLO engine off; ``stats`` renders them."""
    from chunky_bits_tpu.obs import metrics as jax_metrics
    from chunky_bits_tpu_torch.cli.stats import render_summary

    async def main():
        cluster = make_cluster(tmp_path, cache_bytes=1 << 20)
        async with await served(make_app(cluster)) as client:
            assert (await client.put("/a", data=payload_of(9000))).status \
                == 200
            await (await client.get("/a")).read()
            text = await (await client.get("/metrics")).text()
            fams = obs_metrics.parse_exposition(text)
            jax_metrics.parse_exposition(text)
            for name in ("cb_worker_up", "cb_request_total",
                         "cb_cache_misses_total", "cb_build_info",
                         "cb_pipeline_jobs_total"):
                assert name in fams, name
            builds = [labels for _n, labels, _v in
                      fams["cb_build_info"]["samples"]]
            assert any(b["backend"] == "torch" for b in builds), builds
            assert all((b["slo"], b["qos"], b["scrub"]) ==
                       ("off", "off", "off") for b in builds)
            stats = await (await client.get("/stats")).json()
            assert stats["slo"] == {"enabled": False}
            assert stats["qos"] == {"enabled": False}
            assert stats["requests"]["count"] >= 2
            healthz = await (await client.get("/healthz")).json()
            assert healthz["status"] == "ok"
            scrub = await (await client.get("/scrub/status")).json()
            assert scrub == {"enabled": False}
            alerts = await (await client.get("/alerts")).json()
            assert alerts == {"enabled": False}
            traces = await (await client.get("/debug/traces")).json()
            assert traces["enabled"] is False
        await cluster.tunables.location_context().aclose()
        return stats, healthz, scrub, alerts

    import io

    stats, healthz, scrub, alerts = arun(main())
    out = io.StringIO()
    render_summary(stats, healthz, scrub, out, alerts=alerts)
    text = out.getvalue()
    assert "scrub: disabled" in text and "slo: disabled" in text
    assert "cache: hits=" in text


# ---- against the JAX gateway ----

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
    status = int(lines[0].split(" ")[1])
    headers = {}
    for line in lines[1:]:
        key, _, value = line.partition(":")
        headers[key.strip().lower()] = value.strip()
    return status, headers, rest


COMPARED = ("content-length", "content-range", "etag", "content-type")


def test_raw_requests_equal_the_jax_gateway(tmp_path):
    """The same raw requests to a JAX gateway and to the port's, each with
    its own Cluster over one tree: equal status, the reference's headers
    and bodies.  Then a PUT through each reads back through the other
    package's Cluster."""
    from aiohttp import web

    from chunky_bits_tpu.cluster import Cluster as JaxCluster
    from chunky_bits_tpu.gateway import make_app as jax_make_app
    from chunky_bits_tpu.utils import aio as jaio

    payload = payload_of(3 * (3 * CHUNK) + 777)
    small = b"hello gateway\n"

    async def start(app):
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, "127.0.0.1", 0)
        await site.start()
        return runner, site._server.sockets[0].getsockname()[1]

    async def main():
        jax_cluster = JaxCluster.from_obj(
            cluster_spec(tmp_path, backend="numpy"))
        port_cluster = make_cluster(tmp_path)
        profile = jax_cluster.get_profile(None)
        await jax_cluster.write_file("obj", jaio.BytesReader(payload),
                                     profile, "application/x-demo")
        await jax_cluster.write_file("small", jaio.BytesReader(small),
                                     profile, None)
        ref = await port_cluster.get_file_ref("obj")
        etag = file_ref_etag(ref)
        n = len(payload)
        requests = [
            ("GET", "/obj", {}), ("HEAD", "/obj", {}),
            ("GET", "/small", {}),
            ("GET", "/obj", {"Range": "bytes=100-199"}),
            ("GET", "/obj", {"Range": f"bytes={CHUNK - 10}-{CHUNK + 9}"}),
            ("GET", "/obj", {"Range": f"bytes={3 * CHUNK - 5}-"
                                      f"{3 * CHUNK + 4}"}),
            ("GET", "/obj", {"Range": f"bytes={n - 100}-"}),
            ("GET", "/obj", {"Range": "bytes=-300"}),
            ("GET", "/obj", {"Range": f"bytes=-{n + 5}"}),
            ("HEAD", "/obj", {"Range": "bytes=0-9"}),
            ("GET", "/obj", {"Range": f"bytes={n}-"}),
            ("GET", "/obj", {"Range": "bytes=0-5,9-12"}),
            ("GET", "/obj", {"If-None-Match": etag}),
            ("GET", "/obj", {"If-None-Match": etag, "Range": "bytes=0-9"}),
            ("GET", "/obj", {"If-None-Match": '"other"'}),
            ("GET", "/nothing/here", {}),
        ]
        jax_runner, jax_port = await start(jax_make_app(jax_cluster))
        port_runner, port_port = await start(make_app(port_cluster))
        try:
            for method, path, headers in requests:
                head = f"{method} {path} HTTP/1.1\r\nHost: x\r\n" \
                    "Connection: close\r\n"
                head += "".join(f"{k}: {v}\r\n" for k, v in headers.items())
                head = (head + "\r\n").encode()
                theirs = await raw_request(jax_port, head)
                ours = await raw_request(port_port, head)
                case = (method, path, headers)
                assert ours[0] == theirs[0], case
                for key in COMPARED:
                    assert ours[1].get(key) == theirs[1].get(key), \
                        (case, key)
                assert ours[2] == theirs[2], case
            # PUT through each, read back through the other's Cluster
            for put_port, name, reader_cluster, data in (
                    (port_port, "via-port", jax_cluster, payload[:200000]),
                    (jax_port, "via-jax", port_cluster, payload[5000:])):
                head = (f"PUT /{name} HTTP/1.1\r\nHost: x\r\n"
                        f"Connection: close\r\nContent-Type: text/x-t\r\n"
                        f"Content-Length: {len(data)}\r\n\r\n").encode()
                status, _h, _b = await raw_request(put_port, head, data)
                assert status == 200
                ref = await reader_cluster.get_file_ref(name)
                assert ref.content_type == "text/x-t"
                builder = reader_cluster.file_read_builder(ref)
                assert await builder.read_all() == data
            assert (await port_cluster.metadata.read("via-jax")) == \
                (await jax_cluster.metadata.read("via-jax"))
        finally:
            await jax_runner.cleanup()
            await port_runner.cleanup()
        await port_cluster.tunables.location_context().aclose()
        await jax_cluster.tunables.location_context().aclose()

    arun(main())


# ---- the worker fleet ----

def test_worker_fleet_through_the_cli(tmp_path):
    """``python -m chunky_bits_tpu_torch http-gateway --workers 2``: both
    workers report in the fleet ``/metrics``, PUT and GET answer through
    one port, a SIGKILLed worker does not stop the service and its slot
    respawns, and SIGINT stops every process."""
    import aiohttp

    spec = tmp_path / "cluster.yaml"
    spec.write_text(yaml.safe_dump(cluster_spec(tmp_path,
                                                cache_bytes=4 << 20)))
    payload = payload_of(120000)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.Popen(
        [sys.executable, "-m", "chunky_bits_tpu_torch", "--config",
         os.devnull, "http-gateway", str(spec), "-l", "127.0.0.1:0",
         "--workers", "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
        start_new_session=True)

    async def workers_up(session, url, want):
        deadline = time.monotonic() + 45
        while time.monotonic() < deadline:
            try:
                text = await (await session.get(f"{url}/metrics")).text()
                fam = obs_metrics.parse_exposition(text).get("cb_worker_up")
                pids = sorted(s[1]["worker"] for s in
                              (fam or {"samples": []})["samples"])
                if len(pids) == want:
                    return pids
            except aiohttp.ClientError:
                pass
            await asyncio.sleep(0.3)
        raise AssertionError("fleet never reported its workers")

    async def main(url):
        async with aiohttp.ClientSession() as session:
            pids = await workers_up(session, url, 2)
            assert (await session.put(f"{url}/obj", data=payload)).status \
                == 200
            for _ in range(6):
                resp = await session.get(f"{url}/obj")
                assert await resp.read() == payload
            os.kill(int(pids[0]), signal.SIGKILL)
            served = 0
            for _ in range(40):
                try:
                    resp = await session.get(f"{url}/obj")
                    if resp.status == 200:
                        assert await resp.read() == payload
                        served += 1
                except aiohttp.ClientError:
                    pass
                if served >= 5:
                    break
                await asyncio.sleep(0.1)
            assert served >= 5
            live = await workers_up(session, url, 2)
            assert pids[0] not in live
            return {int(pid) for pid in pids + live}

    def running(pid: int) -> bool:
        try:
            with open(f"/proc/{pid}/stat") as f:
                return f.read().rsplit(")", 1)[1].split()[0] != "Z"
        except (OSError, IndexError):
            return False

    seen = set()
    try:
        line = b""
        deadline = time.monotonic() + 60
        while b"listening on" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line and proc.poll() is not None:
                break
        match = re.search(rb"http://127\.0\.0\.1:(\d+) \(2 workers\)", line)
        assert match, (line, proc.stderr.read() if proc.poll() else b"")
        seen = arun(main(f"http://127.0.0.1:{int(match.group(1))}"),
                    timeout=90)
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
    # no worker outlives the supervisor
    assert len(seen) == 3 and not [p for p in seen if running(p)], seen


def test_default_backend_refuses_to_serve_through_the_cpu(tmp_path,
                                                          monkeypatch):
    """With no card, a YAML naming no backend, ``cuda`` or ``jax`` fails
    its first PUT: the port never serves through the CPU."""
    monkeypatch.delenv("CHUNKY_BITS_TORCH_BACKEND", raising=False)

    async def main(backend):
        spec = cluster_spec(tmp_path, backend=backend)
        if backend is None:
            del spec["tunables"]["backend"]
        cluster = Cluster.from_obj(spec)
        async with await served(make_app(cluster)) as client:
            resp = await client.put(f"/o-{backend}",
                                    data=payload_of(3 * CHUNK))
            assert resp.status == 500
            assert (await client.get(f"/o-{backend}")).status == 404
        await cluster.tunables.location_context().aclose()

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    for backend in (None, "cuda", "jax"):
        arun(main(backend))


# ---- storage ops: slab extents and the scrub daemon ----

def slab_spec(tmp_path, **tunables_):
    from tests.test_torch_slab import make_cluster_obj

    return make_cluster_obj(tmp_path, chunk_log2=14,
                            tunables=tunables_ or None)


def test_sendfile_over_slab_extents(tmp_path):
    """A Range inside one packed chunk streams from its slab extent
    (``source=sendfile``), byte-identical; a corrupted extent falls back
    to reassembly, still byte-identical."""
    from tests.test_torch_slab import flip_byte

    payload = payload_of(3 * 16384 + 777, 8)

    async def main():
        cluster = Cluster.from_obj(slab_spec(tmp_path))
        app = make_app(cluster, sendfile=True)
        async with await served(app) as client:
            assert (await client.put("/obj", data=payload)).status == 200
            assert await (await client.get("/obj")).read() == payload
            for lo, hi in ((128, 2175), (200, 300), (16384, 20000)):
                resp = await client.get(
                    "/obj", headers={"Range": f"bytes={lo}-{hi}"})
                assert resp.status == 206
                assert await resp.read() == payload[lo:hi + 1]
            await asyncio.sleep(0.05)  # the access log's finally blocks
            sources = [e.source for e in app[PROFILER_KEY].drain_requests()
                       if e.method == "GET"]
            assert sources.count("sendfile") == 3, sources
            ref = await cluster.get_file_ref("obj")
            flip_byte(ref.parts[0].data[2].locations[0], 11, 1)
            start = 2 * 16384 + 10
            resp = await client.get(
                "/obj", headers={"Range": f"bytes={start}-{start + 99}"})
            assert resp.status == 206
            assert await resp.read() == payload[start:start + 100]
            await asyncio.sleep(0.05)
            entries = app[PROFILER_KEY].drain_requests()
            assert entries[-1].source in ("store", "cache"), entries[-1]
        await cluster.tunables.location_context().aclose()

    arun(main())


def test_serve_runs_the_scrub_daemon_and_reports_it(tmp_path):
    """``serve`` with ``scrub_bytes_per_sec`` set starts the daemon on its
    loop: ``/scrub/status`` answers ``enabled: true`` with its counters
    (a pass that repaired a flipped byte), the ``cb_scrub_*`` and
    ``cb_repair_*`` families parse, objects read alongside, and the
    daemon stops with the server."""
    from aiohttp import ClientSession

    from chunky_bits_tpu_torch.gateway import serve
    from tests.test_torch_slab import flip_byte, write_payload

    cluster = Cluster.from_obj(slab_spec(
        tmp_path, scrub_bytes_per_sec=10_000_000, repair_block_bytes=4096))
    payload = write_payload(cluster, "obj", 3 * 16384, seed=9)
    ref = arun(cluster.get_file_ref("obj"))
    flip_byte(ref.parts[0].data[1].locations[0], 5000)

    async def main():
        ready = asyncio.get_running_loop().create_future()
        task = asyncio.ensure_future(serve(
            cluster, "127.0.0.1", 0,
            on_ready=lambda port: ready.set_result(port)))
        port = await asyncio.wait_for(ready, 30)
        try:
            async with ClientSession() as session:
                url = f"http://127.0.0.1:{port}"
                for _ in range(1500):  # bounded: 15 s at most
                    resp = await session.get(f"{url}/scrub/status")
                    status = await resp.json()
                    assert status["enabled"] is True
                    if status["passes"] >= 1:
                        break
                    await asyncio.sleep(0.01)
                assert status["passes"] >= 1, status
                assert status["running"] is True
                assert status["corrupt"] == 1 and status["repaired"] == 1
                assert status["repair"]["plans_decode"] == 1
                assert status["repair"]["helper_bytes_decode"] == 3 * 4096
                assert await (await session.get(f"{url}/obj")).read() == \
                    payload
                text = await (await session.get(f"{url}/metrics")).text()
                parsed = obs_metrics.parse_exposition(text)
                assert any(s[2] >= 1 for s in
                           parsed["cb_scrub_passes_total"]["samples"])
                assert "cb_repair_plans_total" in parsed
        finally:
            task.cancel()
            await asyncio.gather(task, return_exceptions=True)
        await cluster.tunables.location_context().aclose()

    arun(main())
