"""The port's packed slab store (``chunky_bits_tpu_torch/file/slab.py``) and
its ``slab:`` locations, held against ``tests/test_slab.py`` and against the
JAX package's store.

The assertions of ``tests/test_slab.py`` run on the ``torch``, ``numpy``
and ``native`` backends (its ``jax`` leg is the card's: the name resolves
to ``cuda``).  The golden
``slab_placement.yaml`` must come out byte-equal from the port's writer.  A
store written by either package opens and reads back through the other,
journal lines and extents included, and appends from two processes (one
per package) serialize on the store's ``flock``.  The durability pins go
through the filesystem seam: an append flushes without an fsync, a short
append truncates its tail, a compaction fsyncs around its journal swap.
The gateway's sendfile over slab extents is in ``test_torch_gateway.py``
and the slab GC in ``test_torch_cli.py``.  Tolerance 0 throughout.
"""

import errno
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from chunky_bits_tpu.file import slab as jax_slab
from chunky_bits_tpu_torch.cluster import Cluster
from chunky_bits_tpu_torch.errors import LocationError
from chunky_bits_tpu_torch.file import slab
from chunky_bits_tpu_torch.file.location import (Location, LocationContext,
                                                 Range)
from chunky_bits_tpu_torch.file.weighted_location import WeightedLocation
from chunky_bits_tpu_torch.utils import aio
from chunky_bits_tpu_torch.utils import fsio
from tests.golden import generate as gen
from tests.test_torch_file import golden, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def torch_default(monkeypatch):
    """Unnamed backends are ``torch``; the port's storage knobs start
    unset."""
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    for knob in ("CODE", "METADATA_KIND", "REPAIR_BLOCK_BYTES",
                 "SCRUB_BYTES_PER_SEC", "CACHE_BYTES", "HEDGE_MS"):
        monkeypatch.delenv("CHUNKY_BITS_TORCH_" + knob, raising=False)


def make_cluster_obj(root, packed=True, d=3, p=2, chunk_log2=12,
                     n_nodes=5, tunables=None, code="rs", meta="path"):
    """``tests/test_slab.py``'s cluster: ``n_nodes`` destinations under
    ``root`` (``slab:`` when ``packed``), a yaml path or meta-log metadata
    store, the ``torch`` backend unless ``tunables`` names another."""
    dirs = []
    for i in range(n_nodes):
        path = os.path.join(str(root), f"disk{i}")
        os.makedirs(path, exist_ok=True)
        dirs.append(f"slab:{path}" if packed else path)
    meta_dir = os.path.join(str(root), "meta")
    os.makedirs(meta_dir, exist_ok=True)
    profile = {"data": d, "parity": p, "chunk_size": chunk_log2}
    if code is not None:
        profile["code"] = code
    return {
        "destinations": [{"location": x} for x in dirs],
        "metadata": {"type": meta, "format": "yaml", "path": meta_dir},
        "profiles": {"default": profile},
        "tunables": {"backend": "torch", **(tunables or {})},
    }


def payload_of(n, seed=0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def write_payload(cluster, name, nbytes, seed=0) -> bytes:
    data = payload_of(nbytes, seed)
    run(cluster.write_file(name, aio.BytesReader(data),
                           cluster.get_profile()))
    return data


def flip_byte(location, offset, mask=0xFF):
    """One-byte corruption at a chunk offset of a path or slab replica."""
    if location.is_slab():
        path, base, length = location.slab_extent()
        pos = base + min(offset, length - 1)
    else:
        path, pos = location.target, offset
    with open(path, "r+b") as f:
        f.seek(pos)
        byte = f.read(1)
        f.seek(pos)
        f.write(bytes([byte[0] ^ mask]))


async def read_back(cluster, name) -> bytes:
    return await cluster.file_read_builder(
        await cluster.get_file_ref(name)).read_all()


# ---- parsing and hierarchy ----

def test_parse_roundtrip_and_hierarchy(tmp_path):
    root = str(tmp_path / "store")
    loc = Location.parse(f"slab:{root}")
    assert loc.is_slab() and not loc.is_local() and not loc.is_http()
    assert str(loc) == f"slab:{root}"
    child = loc.child("sha256-ab")
    assert str(child) == f"slab:{root}/sha256-ab"
    assert child.is_child_of(loc) and loc.is_parent_of(child)
    assert Location.parse(str(child)) == child
    ranged = Location.parse(f"(5,10)slab:{root}/sha256-ab")
    assert ranged.range == Range(5, 10, False)
    assert ranged.target == f"{root}/sha256-ab"
    assert str(ranged) == f"(5,10)slab:{root}/sha256-ab"
    wl = WeightedLocation.parse(f"750:slab:{root}")
    assert wl.weight == 750 and wl.location.is_slab()
    with pytest.raises(Exception):
        Location.parse("slab:")
    with pytest.raises(LocationError, match="names a store root"):
        run(Location.parse("slab:store").file_exists())


def test_health_key_is_store_root(tmp_path):
    from chunky_bits_tpu.cluster.health import location_key as jax_key
    from chunky_bits_tpu.file.location import Location as JaxLocation
    from chunky_bits_tpu_torch.cluster.health import location_key

    s = f"slab:{tmp_path}/store/sha256-ab"
    assert location_key(Location.parse(s)) == ("local", f"{tmp_path}/store")
    assert location_key(Location.parse(s)) == \
        jax_key(JaxLocation.parse(s))


# ---- store mechanics ----

def test_store_append_lookup_delete_reload(tmp_path):
    root = str(tmp_path / "s")
    store = slab.SlabStore(root)
    ext = store.append("sha256-aa", b"A" * 100)
    store.append("sha256-bb", b"B" * 50)
    assert ext.offset == 0 and ext.length == 100
    assert store.pread("sha256-aa") == b"A" * 100
    assert store.pread("sha256-bb", 10, 5) == b"B" * 5
    assert store.lookup("sha256-cc") is None
    other = slab.SlabStore(root)
    assert other.pread("sha256-bb") == b"B" * 50
    store.mark_dead("sha256-aa")
    assert store.lookup("sha256-aa") is None
    assert store.dead_bytes() == 100
    assert other.lookup("sha256-aa") is None
    with pytest.raises(FileNotFoundError):
        store.mark_dead("sha256-aa")
    with pytest.raises(FileNotFoundError):
        store.pread("sha256-zz")
    with pytest.raises(slab.SlabStoreError):
        store.append("a/b", b"x")
    assert store.stats() == {"root": root, "live_chunks": 1,
                             "live_bytes": 50, "dead_bytes": 100,
                             "slab_files": 1}
    assert slab.is_slab_root(root) and not slab.is_slab_root(str(tmp_path))
    assert slab.get_store(root) is slab.get_store(root + "/")


def test_supersede_marks_old_extent_dead(tmp_path):
    store = slab.SlabStore(str(tmp_path / "s"))
    store.append("sha256-aa", b"old-bytes!")
    store.append("sha256-aa", b"new")
    assert store.pread("sha256-aa") == b"new"
    assert store.dead_bytes() == 10


def test_torn_journal_tail_is_ignored_and_repaired(tmp_path):
    root = str(tmp_path / "s")
    store = slab.SlabStore(root)
    store.append("sha256-aa", b"AAAA")
    with open(store.journal_path(), "ab") as f:
        f.write(b'{"o":"p","n":"sha256-torn","s":"sl')
    fresh = slab.SlabStore(root)
    assert fresh.live_names() == ["sha256-aa"]
    assert fresh.lookup("sha256-torn") is None
    # the next append terminates the fragment; nothing merges into it
    fresh.append("sha256-bb", b"BBBB")
    again = slab.SlabStore(root)
    assert sorted(again.live_names()) == ["sha256-aa", "sha256-bb"]
    assert again.pread("sha256-bb") == b"BBBB"
    # and the JAX package reads the repaired journal the same way
    theirs = jax_slab.SlabStore(root)
    assert sorted(theirs.live_names()) == ["sha256-aa", "sha256-bb"]


def test_unreferenced_slab_tail_is_invisible(tmp_path):
    root = str(tmp_path / "s")
    store = slab.SlabStore(root)
    store.append("sha256-aa", b"AAAA")
    with open(store.slab_path("slab-000001.slab"), "ab") as f:
        f.write(b"CRASHED-WRITER-BYTES")
    fresh = slab.SlabStore(root)
    assert fresh.live_names() == ["sha256-aa"]
    assert fresh.pread("sha256-aa") == b"AAAA"
    fresh.append("sha256-bb", b"BBBB")
    assert fresh.pread("sha256-bb") == b"BBBB"


def test_rollover_past_slab_max_bytes(tmp_path):
    store = slab.SlabStore(str(tmp_path / "s"), slab_max_bytes=100)
    for i in range(6):
        store.append(f"sha256-{i:02d}", bytes([i]) * 40)
    assert len(store.slab_files()) >= 2
    for i in range(6):
        assert store.pread(f"sha256-{i:02d}") == bytes([i]) * 40


def test_compact_reclaims_and_preserves(tmp_path):
    store = slab.SlabStore(str(tmp_path / "s"), slab_max_bytes=200)
    payloads = {f"sha256-{i:02d}": os.urandom(50) for i in range(8)}
    for name, data in payloads.items():
        store.append(name, data)
    # a view held across the compaction keeps the old inode readable
    held = store.map_view("sha256-03")
    assert held.readonly  # views are never written through
    for name in ("sha256-00", "sha256-05"):
        store.mark_dead(name)
        del payloads[name]
    report = store.compact()
    assert report["reclaimed_bytes"] == 100
    assert report["live_chunks"] == len(payloads)
    for name, data in payloads.items():
        assert store.pread(name) == data
    assert store.dead_bytes() == 0
    assert bytes(held) == payloads["sha256-03"]
    fresh = slab.SlabStore(str(tmp_path / "s"))
    assert sorted(fresh.live_names()) == sorted(payloads)
    assert sorted(jax_slab.SlabStore(str(tmp_path / "s")).live_names()) \
        == sorted(payloads)


def test_concurrent_appends_from_two_instances(tmp_path):
    root = str(tmp_path / "s")
    a, b = slab.SlabStore(root), slab.SlabStore(root)
    errors = []

    def writer(store, prefix):
        try:
            for i in range(20):
                store.append(f"sha256-{prefix}{i:02d}",
                             f"{prefix}{i}".encode() * 10)
        except Exception as err:  # noqa: BLE001 — surfaced via errors
            errors.append(err)

    threads = [threading.Thread(target=writer, args=(a, "a"), daemon=True),
               threading.Thread(target=writer, args=(b, "b"), daemon=True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert len(a.live_names()) == 40
    assert len(b.live_names()) == 40
    assert a.pread("sha256-b07") == b"b7" * 10


APPENDER = """
import sys
from {pkg}.file.slab import SlabStore
store = SlabStore(sys.argv[1])
for i in range(40):
    store.append(f"sha256-{tag}{{i:02d}}", b"{tag}%d" % i * 7)
print(len(store.live_names()))
"""


def test_cross_process_appends_serialize_on_flock(tmp_path):
    """Two real processes, one per package, append to one store at once
    (each under its own timeout): every record publishes, and both
    packages read the same 80 extents back."""
    root = str(tmp_path / "s")
    os.makedirs(root)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CHUNKY_BITS_")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, "-c", APPENDER.format(pkg=pkg, tag=tag), root],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pkg, tag in (("chunky_bits_tpu_torch", "t"),
                         ("chunky_bits_tpu", "j"))]
    for proc in procs:
        try:
            out, err = proc.communicate(timeout=60)
        finally:
            proc.kill()
        assert proc.returncode == 0, err.decode()
        assert 40 <= int(out) <= 80
    ours, theirs = slab.SlabStore(root), jax_slab.SlabStore(root)
    assert len(ours.live_names()) == 80
    assert ours.live_extents() == theirs.live_extents()
    for tag in "tj":
        for i in (0, 17, 39):
            assert ours.pread(f"sha256-{tag}{i:02d}") == \
                b"%s%d" % (tag.encode(), i) * 7
    # no two extents overlap: the appends serialized
    spans = sorted((e.slab, e.offset, e.offset + e.length)
                   for _n, e in ours.live_extents())
    for (s0, _a0, e0), (s1, a1, _e1) in zip(spans, spans[1:]):
        assert s0 != s1 or e0 <= a1


# ---- on-disk format against the JAX package ----

@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_bytes_open_in_the_other_package(tmp_path, writer):
    """A store written (appends, a supersede, a delete, a compaction,
    more appends) by one package reads back identically through the
    other; the journal lines differ only in their publish stamps."""
    root = str(tmp_path / writer)
    mod, other = (slab, jax_slab) if writer == "port" else (jax_slab, slab)
    store = mod.SlabStore(root, slab_max_bytes=300)
    blobs = {f"sha256-{i:02d}": payload_of(40 + 13 * i, i)
             for i in range(10)}
    for name, data in blobs.items():
        store.append(name, data)
    store.append("sha256-03", b"superseded")
    blobs["sha256-03"] = b"superseded"
    store.mark_dead("sha256-05")
    del blobs["sha256-05"]
    store.compact()
    store.append("sha256-99", b"after compaction")
    blobs["sha256-99"] = b"after compaction"
    reader = other.SlabStore(root)
    assert reader.live_extents() == store.live_extents()
    for name, data in blobs.items():
        assert reader.pread(name) == data
        assert bytes(reader.map_view(name)) == data
    with open(os.path.join(root, "index.jsonl"), "rb") as f:
        lines = [json.loads(line) for line in f]
    assert all(set(obj) <= {"o", "n", "s", "f", "l", "t"} for obj in lines)
    # the other package appends onto this store and both agree
    reader.append("sha256-zz", b"cross")
    assert store.pread("sha256-zz") == b"cross"


# ---- durability through the fsio seam ----

def test_append_flushes_without_fsync_and_compact_fsyncs(tmp_path):
    root = str(tmp_path / "s")
    store = slab.SlabStore(root)
    rec = fsio.RecordingFsProvider(root)
    prev = fsio.install(rec)
    try:
        store.append("sha256-aa", b"A" * 64)
        store.append("sha256-bb", b"B" * 64)
        appends = list(rec.ops)
        store.mark_dead("sha256-aa")
        del rec.ops[:]
        store.compact()
        compact = list(rec.ops)
    finally:
        fsio.install(prev)
    kinds = [op.op for op in appends]
    assert "fsync" not in kinds and "fsync_dir" not in kinds, kinds
    # each append: slab bytes (write + flush), then one journal write
    writes = [op for op in appends if op.op == "write"]
    assert [os.path.basename(op.path) for op in writes] == \
        ["slab-000001.slab", "index.jsonl"] * 2
    kinds = [op.op for op in compact]
    assert kinds.count("fsync") == 2 and kinds.count("fsync_dir") == 1
    assert kinds.index("replace") < kinds.index("fsync_dir")
    assert kinds.index("fsync") < kinds.index("replace")
    assert store.pread("sha256-bb") == b"B" * 64


def test_short_append_truncates_its_tail(tmp_path):
    root = str(tmp_path / "s")
    store = slab.SlabStore(root)
    store.append("sha256-aa", b"A" * 100)
    prev = fsio.install(fsio.FaultyFsProvider(
        "write", path_suffix=".slab", errno_code=errno.ENOSPC,
        short_bytes=37))
    try:
        with pytest.raises(OSError):
            store.append("sha256-bb", b"B" * 100)
    finally:
        fsio.install(prev)
    assert os.path.getsize(store.slab_path("slab-000001.slab")) == 100
    assert store.live_names() == ["sha256-aa"]
    store.append("sha256-cc", b"C" * 10)
    assert store.lookup("sha256-cc").offset == 100
    assert slab.SlabStore(root).pread("sha256-cc") == b"C" * 10


# ---- the Location surface over the store ----

def test_location_verbs_roundtrip(tmp_path):
    loc = Location.parse(f"slab:{tmp_path}/store").child("sha256-xy")

    async def main():
        assert not await loc.file_exists()
        with pytest.raises(LocationError):
            await loc.file_len()
        with pytest.raises(LocationError):
            await loc.read()
        await loc.write(b"0123456789" * 10)
        assert await loc.file_exists()
        assert await loc.file_len() == 100
        assert await loc.read() == b"0123456789" * 10
        assert await loc.with_range(Range(95)).read() == b"56789"
        assert await loc.with_range(Range(4, 3)).read() == b"456"
        assert await loc.with_range(Range(95, 10)).read() == b"56789"
        zext = await loc.with_range(Range(95, 10, True)).read()
        assert zext == b"56789" + b"\0" * 5
        view = await loc.read_view()
        assert bytes(view) == b"0123456789" * 10 and view.readonly
        rview = await loc.with_range(Range(4, 3)).read_view()
        assert bytes(rview) == b"456"
        assert await loc.with_range(Range(95, 10)).read_view() is None
        reader = await loc.with_range(Range(10, 25)).reader()
        got = b""
        while True:
            piece = await reader.read(7)
            if not piece:
                break
            got += piece
        await aio.close_reader(reader)
        assert got == (b"0123456789" * 10)[10:35]
        sibling = Location.parse(f"slab:{tmp_path}/store/sha256-zz")
        n = await sibling.write_from_reader(aio.BytesReader(b"stream-bytes"))
        assert n == 12
        assert await sibling.read() == b"stream-bytes"
        cx = LocationContext(on_conflict="ignore")
        await sibling.write(b"different", cx)
        assert await sibling.read() == b"stream-bytes"
        assert await sibling.write_from_reader(
            aio.BytesReader(b"other"), cx) == 0
        await sibling.delete()
        assert not await sibling.file_exists()
        with pytest.raises(LocationError):
            await sibling.delete()

    run(main())


def test_write_shard_places_into_store(tmp_path):
    from chunky_bits_tpu_torch.file.hashing import AnyHash

    root_loc = Location.parse(f"slab:{tmp_path}/store")

    async def main():
        data = b"shard-payload" * 9
        hash_ = AnyHash.from_buf(data)
        locations = await root_loc.write_shard(hash_, data)
        assert len(locations) == 1 and locations[0].is_slab()
        assert await locations[0].read() == data
        assert slab.get_store(f"{tmp_path}/store").live_names() == \
            [str(hash_)]

    run(main())


# ---- byte identity across layouts, backends and packages ----

def test_cluster_writes_the_slab_placement_golden(tmp_path, monkeypatch):
    """tests/golden/generate.py's fixture 4 through the port's Cluster:
    relative ``slab:`` destinations, hash-seeded weighted placement."""
    monkeypatch.chdir(tmp_path)
    for i in range(5):
        os.mkdir(f"d{i}")
    os.mkdir("meta")
    spec = gen.cluster_spec("meta")
    for node in spec["destinations"]:
        node["location"] = "slab:" + node["location"]
    cluster = Cluster.from_obj(spec)
    ref = run(cluster.get_file_writer(cluster.get_profile())
              .write(aio.BytesReader(gen.payload(30_000, 3))))
    assert gen.dump(ref.to_obj()) == golden("slab_placement")


@pytest.mark.parametrize("backend", ["torch", "numpy", "native"])
def test_byte_identity_vs_path_destinations(tmp_path, backend):
    payload = payload_of(40000, 5)

    async def one(packed):
        cluster = Cluster.from_obj(make_cluster_obj(
            tmp_path / ("slab" if packed else "files"), packed=packed,
            tunables={"backend": backend}))
        await cluster.write_file("obj", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("obj")
        assert await read_back(cluster, "obj") == payload
        return [str(c.hash) for part in ref.parts
                for c in part.data + part.parity]

    assert run(one(True)) == run(one(False))


def test_reconstruct_from_erased_extents(tmp_path):
    payload = payload_of(60000, 6)

    async def main():
        cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
        await cluster.write_file("obj", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("obj")
        for part in ref.parts:
            await part.data[0].locations[0].delete()
            await part.parity[0].locations[0].delete()
        assert await cluster.file_read_builder(ref).read_all() == payload
        report = await ref.resilver(
            cluster.get_destination(cluster.get_profile()),
            backend="torch")
        assert not report.failed_writes(), report.failed_writes()
        await cluster.write_file_ref("obj", ref)
        verify = await ref.verify(cluster.tunables.location_context())
        assert str(verify.integrity()) == "Valid"
        assert await cluster.file_read_builder(ref).read_all() == payload

    run(main())


def test_corrupt_extent_falls_through_to_rebuild(tmp_path):
    payload = payload_of(30000, 7)

    async def main():
        cluster = Cluster.from_obj(make_cluster_obj(tmp_path))
        await cluster.write_file("obj", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("obj")
        loc = ref.parts[0].data[1].locations[0]
        flip_byte(loc, loc.slab_extent()[2] // 3, 0x40)
        assert await cluster.file_read_builder(ref).read_all() == payload

    run(main())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_slab_cluster_reads_through_the_other_package(tmp_path, writer):
    """A slab cluster written by one package (the port on ``torch``, the
    JAX package on ``numpy``) reads back byte-identically through the
    other, which then writes a second object the first reads."""
    from chunky_bits_tpu.cluster import Cluster as JaxCluster

    spec = make_cluster_obj(tmp_path)
    jspec = dict(spec, tunables={"backend": "numpy"})
    ours, theirs = Cluster.from_obj(spec), JaxCluster.from_obj(jspec)
    first, second = (ours, theirs) if writer == "port" else (theirs, ours)
    a, b = payload_of(33333, 1), payload_of(12345, 2)

    async def main():
        await first.write_file("a", aio.BytesReader(a),
                               first.get_profile())
        assert await read_back(second, "a") == a
        await second.write_file("b", aio.BytesReader(b),
                                second.get_profile())
        assert await read_back(first, "b") == b
        assert (await ours.get_file_ref("a")).to_obj() == \
            (await theirs.get_file_ref("a")).to_obj()

    run(main())
