"""``chip_smoke.py``'s baseline_ab group on the CPU, against the JAX package.

Each leg of the group (BASELINE configs 4, 6, 7, 8, 10, 18 and 17, as the
JAX package's ``bench.py`` defines their A/Bs) runs here on the port's
``torch`` backend at a small size, and its bytes, references, sets and
counters are held against the JAX package on the same seeded inputs:
tolerance 0 for bytes, exact equality for sets and counts.  On the card
the same functions run at bench.py's sizes on ``cuda``.
"""

import asyncio
import os
import threading

import numpy as np
import pytest
import torch

import chip_smoke as cs
from chunky_bits_tpu.cluster import Cluster as JaxCluster
from chunky_bits_tpu.ops.backend import NumpyBackend as JaxNumpy
from chunky_bits_tpu.utils import aio as jaio
from chunky_bits_tpu_torch.ops.backend import get_backend
from chunky_bits_tpu_torch.utils.virtualmesh import virtual_devices

#: seconds a test may wait on the event loop or the host threads: a hang
#: fails the test instead of cutting the suite
TIMEOUT = 60


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


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Torch's intra-op workers spin: many tiny applies under xdist run
    far slower on its default thread count."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def be():
    return get_backend("torch")


@pytest.fixture
def rec(be):
    recorder = cs.ApplyRecorder(be)
    yield recorder
    recorder.close()


#: the seeded source every leg cuts its objects from
BLOB = np.random.default_rng(cs.SEED + 4).integers(
    0, 256, 2 << 20, dtype=np.uint8).tobytes()


def counted(record):
    """A ``path`` for the legs: runs the step and records its name."""

    def path(name, fn, *args):
        record.append(name)
        return fn(*args)

    return path


def jax_cluster(root, geo, extra=None, slab=False):
    """The JAX package's cluster over d+p fresh ``path`` (or ``slab:``)
    directories on its numpy backend."""
    dirs = []
    for i in range(geo.d + geo.p):
        dirs.append(os.path.join(root, f"d{i}"))
        os.makedirs(dirs[-1])
    os.makedirs(os.path.join(root, "meta"))
    return JaxCluster.from_obj({
        "destinations": [{"location": f"slab:{d}" if slab else d}
                         for d in dirs],
        "metadata": {"type": "path", "format": "yaml",
                     "path": os.path.join(root, "meta")},
        "profiles": {"default": {"data": geo.d, "parity": geo.p,
                                 "chunk_size": geo.chunk.bit_length() - 1}},
        "tunables": {"backend": "numpy", **(extra or {})}})


def jax_write(root, geo, payload, extra=None):
    """``payload`` written by the JAX package; returns its reference."""

    async def go():
        cluster = jax_cluster(root, geo, extra)
        ref = await cluster.write_file("obj", jaio.BytesReader(payload),
                                       cluster.get_profile(None))
        got = await cluster.file_read_builder(ref).read_all()
        await cluster.tunables.location_context().aclose()
        return ref, got

    return bounded(lambda: asyncio.run(go()))


@pytest.mark.parametrize("inflight", [4, 16])
def test_config4_parity_and_digests_equal_the_jax_coder(be, inflight):
    geo = cs.Geometry(8, 3, 4096, ())
    steps = []
    out = bounded(lambda: cs.ab_config4(BLOB, counted(steps), be,
                                        objects=40, geo=geo,
                                        inflight=inflight,
                                        oracle=JaxNumpy()))
    assert steps == ["ab4_host_sha", "ab4_device_sha"]
    from chunky_bits_tpu.ops import get_coder as jax_coder

    coder = jax_coder(8, 3, "numpy")
    objs = cs.ab_objects(BLOB, 40, geo)
    for name in steps:
        leg = out["legs"][name]
        for obj, (parity, digests) in zip(objs, leg["outs"]):
            want_p, want_d = coder.encode_hash_batch(obj)
            assert np.array_equal(parity, want_p)
            assert np.array_equal(digests, want_d)
        # the merging backend: a group is one dispatch, and the walk's
        # launches are the recorder's dispatches
        assert leg["dispatches"] == leg["groups"]
        assert out["expected"][name]["gf_apply"] == leg["dispatches"]
        assert max(b for b, _r, _k, _s in leg["shapes"]) == inflight
        assert sum(b for b, _r, _k, _s in leg["shapes"]) == 40
    assert out["expected"]["ab4_host_sha"]["sha256_rows"] == 0
    assert (out["expected"]["ab4_device_sha"]["sha256_rows"]
            == out["legs"]["ab4_device_sha"]["dispatches"])


def test_config4_windows_are_distinct_views():
    objs = cs.ab_objects(BLOB, 64, cs.Geometry(8, 3, 4096, ()))
    assert all(o.base is not None and o.shape == (1, 8, 4096) for o in objs)
    assert len({o.tobytes() for o in objs}) == 64


def test_config6_reads_and_reference_equal_the_jax_writer(tmp_path, be,
                                                          rec):
    geo = cs.Geometry(3, 2, 16384, ())
    steps = []
    out = bounded(lambda: cs.ab_config6(str(tmp_path / "port"), BLOB,
                                        counted(steps), be, rec,
                                        nbytes=300_000, reads=3, geo=geo))
    assert steps == [f"ab6_{leg}_{step}" for leg in ("off", "on")
                     for step in ("write", "warm", "reads")]
    payload = cs.source_slice(BLOB, 0, 300_000)
    ref, got = jax_write(str(tmp_path / "jax"), geo, payload)
    assert got == payload
    assert out["refs"] == [cs.ref_layout(ref)] * 2
    # off: no cache; on: every timed read served from it, no decode
    assert (out["off"]["hits"], out["off"]["misses"]) == (0, 0)
    assert out["on"]["hits"] >= 3 * 3 * len(ref.parts)
    assert (out["on"]["misses"], out["on"]["read_dispatches"]) == (0, 0)
    assert out["expected"]["ab6_on_reads"]["gf_apply"] == 0
    assert (out["expected"]["ab6_off_reads"]["gf_apply"]
            == out["off"]["read_dispatches"])


def test_config7_references_equal_the_jax_gateway_put(tmp_path, be, rec):
    from aiohttp import ClientSession
    from aiohttp.test_utils import TestServer

    from chunky_bits_tpu.gateway import make_app as jax_app

    geo = cs.Geometry(3, 2, 16384, ())
    steps = []
    out = bounded(lambda: cs.ab_config7(str(tmp_path / "port"), BLOB,
                                        counted(steps), be, rec,
                                        nbytes=200_000, trials=2, geo=geo))
    assert steps == ["ab7_host1_put", "ab7_host1_get", "ab7_host2_put",
                     "ab7_host2_get"]
    payload = cs.source_slice(BLOB, 0, 200_000)

    async def go():
        cluster = jax_cluster(str(tmp_path / "jax"), geo,
                              {"host_threads": 1})
        server = TestServer(jax_app(cluster))
        await server.start_server()
        try:
            async with ClientSession() as session:
                resp = await session.put(server.make_url("/obj"),
                                         data=payload)
                assert resp.status == 200, resp.status
                resp.release()
            return await cluster.get_file_ref("obj")
        finally:
            await server.close()
            await cluster.tunables.location_context().aclose()
            cluster.host_pipeline().close()

    ref = bounded(lambda: asyncio.run(go()))
    assert out["refs"] == [cs.ref_layout(ref)] * 2


def test_config8_off_leg_never_hedges_and_on_leg_keeps_its_budget(
        tmp_path, be, rec):
    steps = []
    out = bounded(lambda: cs.ab_config8(str(tmp_path), BLOB, counted(steps),
                                        be, rec, parts=4,
                                        geo=cs.Geometry(3, 2, 4096, ()),
                                        reads=10, delay_s=0.1))
    assert steps == ["ab8_write", "ab8_hedge0", "ab8_hedge10"]
    off, on = out["off"], out["on"]
    assert off["hedges_fired"] == off["hedges_won"] == 0
    assert 0 < on["hedges_fired"] <= on["budget"]
    assert on["budget"] == pytest.approx(0.05 * on["primaries"] + 8)
    assert on["p99_ms"] < off["p99_ms"]
    # every GET of node 0 stalls at least 75 ms, and the off leg walks
    # each chunk's locations in order
    assert off["p99_ms"] >= 75


def test_config10_candidate_sets_equal_the_jax_layouts(tmp_path, be, rec):
    from chunky_bits_tpu.file import slab as jax_slab

    geo = cs.AB10_GEO
    steps = []
    out = bounded(lambda: cs.ab_config10(str(tmp_path / "port"), BLOB,
                                         counted(steps), be, rec,
                                         objects=20))
    assert steps == ["ab10_files_put", "ab10_files_get", "ab10_slab_put",
                     "ab10_slab_get"]
    dirs = geo.d + geo.p
    port_slab = str(tmp_path / "port" / "ab10_slab")
    jax_names = set()
    for i in range(dirs):
        jax_names.update(jax_slab.get_store(
            os.path.join(port_slab, f"d{i}")).live_names())
    assert jax_names == out["slab"]["candidates"]

    async def go(root, slab):
        cluster = jax_cluster(root, geo, slab=slab)
        for i in range(20):
            await cluster.write_file(
                f"o{i:04d}", jaio.BytesReader(
                    cs.source_slice(BLOB, i * cs.AB10_OBJ, cs.AB10_OBJ)),
                cluster.get_profile(None))
        await cluster.tunables.location_context().aclose()

    for layout, slab in (("files", False), ("slab", True)):
        root = str(tmp_path / f"jax_{layout}")
        bounded(lambda: asyncio.run(go(root, slab)))
        if slab:
            names = set()
            for i in range(dirs):
                names.update(jax_slab.get_store(
                    os.path.join(root, f"d{i}")).live_names())
        else:
            names = cs.gc_candidates(root, dirs, False)
        assert names == out[layout]["candidates"], layout


def jax_stores():
    from chunky_bits_tpu.cluster.meta_log import MetadataLog, MetaLogStore
    from chunky_bits_tpu.cluster.metadata import MetadataFormat, MetadataPath

    return MetadataFormat, MetadataPath, MetadataLog, MetaLogStore


def test_config18_listings_and_liveness_equal_the_jax_meta_log(tmp_path):
    from chunky_bits_tpu_torch.cluster.meta_log import (MetadataLog,
                                                        MetaLogStore)
    from chunky_bits_tpu_torch.cluster.metadata import MetadataFormat

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = bounded(lambda: cs.ab_config18(str(tmp_path / "port"),
                                          objects=300))
    ref = bounded(lambda: cs.ab_config18(str(tmp_path / "jax"),
                                         objects=300, stores=jax_stores()))
    for kind in ("path", "log"):
        for key in ("files", "subtree", "live"):
            assert port[kind][key] == ref[kind][key], (kind, key)
    assert len(port["log"]["live"]) == 300 * 5
    # the namespace the JAX meta-log wrote, read through the port's index
    jax_meta = ref["log"]["meta"]
    names = [cs.ab18_name(i) for i in range(300)]
    store = MetaLogStore(jax_meta)
    assert sorted(store.live_names()) == sorted(names)
    jax_store = jax_stores()[3](jax_meta)
    for name in names[::7]:
        assert store.read_bytes(name) == jax_store.read_bytes(name)

    async def index():
        meta = MetadataLog(path=jax_meta,
                           format=MetadataFormat("json-strict"))
        live = set()
        for _name, hashes in await meta.namespace_hashes():
            live.update(hashes)
        return (sorted(await meta.list_files_recursive("")),
                sorted(await meta.list_files_recursive("ns07")), live)

    files, subtree, live = bounded(lambda: asyncio.run(index()))
    assert files == ref["log"]["files"]
    assert subtree == ref["log"]["subtree"]
    assert live == ref["log"]["live"]


def test_config17_counters_and_bytes_on_eight_virtual_devices(be, rec):
    steps = []
    devices = virtual_devices(8, "cpu")
    out = bounded(lambda: cs.ab_config17(counted(steps), be, rec, devices,
                                         geo=cs.Geometry(10, 4, 4096, ()),
                                         parts=16, batches=4, iters=1,
                                         oracle=JaxNumpy()))
    assert steps == ["ab17_single", "ab17_mesh", "ab17_mesh_nopipe"]
    assert out["layout"] == "dp8/sp1"
    on, off = out["mesh"]["window"], out["mesh_nopipe"]["window"]
    # 4 batches encoded and decoded twice (the identity pass and one
    # timed iteration): 16 submits, one block each over 8 devices
    for window in (on, off):
        assert window["submitted"] == window["completed"] == 16
    assert on["max_inflight"] >= 2 and on["submits_while_busy"] >= 1
    assert on["host_overlap_s"] > 0
    assert off["max_inflight"] <= 1 and off["submits_while_busy"] == 0
    assert off["host_overlap_s"] == 0
    for name in ("ab17_mesh", "ab17_mesh_nopipe"):
        assert out["expected"][name]["gf_apply"] == 16 * 8
        assert out["expected"][name]["gf_acc"] == 0
    assert out["expected"]["ab17_single"]["gf_apply"] == 8
