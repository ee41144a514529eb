"""The port's indexed metadata plane (``chunky_bits_tpu_torch/cluster/
meta_log.py``), held against ``tests/test_meta_log.py`` and against the JAX
package's store.

The assertions of ``tests/test_meta_log.py`` run on the port's store.  The
golden ``meta_log_placement.yaml`` must come out byte-equal from the
port's cluster.  A store written by either package, compacted by either
(the ``meta-compact`` CLI included), opens in the other with equal index
entries and ref bytes; two real processes (one per package) append to one
store under its ``flock``.  The durability pins go through the filesystem
seam: every publish fsyncs the log, then the journal line, plus the
directory when a file was created, before it returns; a failing fsync
aborts the publish; a torn journal tail is ignored and then terminated.
Tolerance 0 throughout.
"""

import os
import subprocess
import sys
import threading

import pytest
import yaml

from chunky_bits_tpu.cluster import meta_log as jax_meta_log
from chunky_bits_tpu_torch.cluster import Cluster, tunables
from chunky_bits_tpu_torch.cluster import meta_log
from chunky_bits_tpu_torch.cluster.meta_log import (MetadataLog,
                                                    MetaLogStore, norm_name)
from chunky_bits_tpu_torch.cluster.metadata import (MetadataFormat,
                                                    MetadataPath,
                                                    metadata_from_obj)
from chunky_bits_tpu_torch.errors import MetadataReadError
from chunky_bits_tpu_torch.utils import aio, fsio
from tests.golden import generate as gen
from tests.test_torch_file import golden, run
from tests.test_torch_slab import REPO, payload_of, read_back


@pytest.fixture(autouse=True)
def torch_default(monkeypatch):
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    for knob in ("METADATA_KIND", "CACHE_BYTES", "REPAIR_BLOCK_BYTES",
                 "CODE"):
        monkeypatch.delenv("CHUNKY_BITS_TORCH_" + knob, raising=False)


def store_at(tmp_path, name="m", **kwargs) -> MetaLogStore:
    return MetaLogStore(str(tmp_path / name), **kwargs)


def test_norm_name_equals_jax():
    for s in ("a/b/c", "/a//b/./../c/", ".", "", "../../x", "a/./"):
        assert norm_name(s) == jax_meta_log.norm_name(s)
    assert norm_name("/a//b/./../c/") == "a/b/c"
    assert norm_name(".") == ""


# ---- store protocol ----

def test_append_read_list_roundtrip(tmp_path):
    store = store_at(tmp_path)
    store.append("dir/a", b"ref-a")
    store.append("dir/sub/b", b"ref-b")
    store.append("top", b"ref-top")
    assert store.read_bytes("dir/a") == b"ref-a"
    assert store.live_names() == ["dir/a", "dir/sub/b", "top"]
    assert store.prefix_names("dir") == ["dir/a", "dir/sub/b"]
    assert store.prefix_names("") == ["dir/a", "dir/sub/b", "top"]
    kind, children = store.list_children("")
    assert kind == "directory"
    assert children == [("directory", "dir"), ("file", "top")]
    assert store.list_children("dir")[1] == [("file", "a"),
                                             ("directory", "sub")]
    assert store.list_children("top") == ("file", [])
    assert store.list_children("nope") is None
    assert store.live_count() == 3
    assert meta_log.is_meta_log_root(store.root)
    assert meta_log.get_store(store.root) is meta_log.get_store(
        store.root + "/")


def test_missing_and_tombstoned_names_raise_enoent(tmp_path):
    store = store_at(tmp_path)
    with pytest.raises(FileNotFoundError):
        store.read_bytes("ghost")
    store.append("x", b"one")
    store.tombstone("x")
    with pytest.raises(FileNotFoundError):
        store.read_bytes("x")
    with pytest.raises(FileNotFoundError):
        store.tombstone("x")
    with pytest.raises(meta_log.MetaLogError):
        store.append("./", b"no name")
    store.append("x", b"two")
    assert store.read_bytes("x") == b"two"


def test_supersede_tombstone_cold_reload_and_rollover(tmp_path):
    store = store_at(tmp_path)
    store.append("a", b"x" * 100)
    store.append("a", b"y" * 40)
    assert store.dead_bytes() == 100
    store.tombstone("a")
    assert store.dead_bytes() == 140
    store.append("b/c", b"ref-c")
    cold = MetaLogStore(store.root)
    assert cold.live_names() == ["b/c"]
    assert cold.read_bytes("b/c") == b"ref-c"
    assert cold.generation() == store.generation() == 4
    small = store_at(tmp_path, "r", log_max_bytes=64)
    for i in range(6):
        small.append(f"n{i}", bytes([65 + i]) * 40)
    assert len(small.log_files()) >= 3
    raw = small.read_many(small.entries_for(["n4", "ghost", "n1", "n3"]))
    assert [name for name, _ in raw] == ["n4", "n1", "n3"]
    assert raw[0][1] == b"E" * 40


def test_compact_reclaims_drops_tombstones_and_keeps_generation(tmp_path):
    store = store_at(tmp_path)
    store.append("keep", b"k" * 50)
    store.append("dead", b"d" * 70)
    store.append("keep", b"K" * 30)
    store.tombstone("dead")
    gen_ = store.generation()
    old_logs = [store.log_path(log) for log in store.log_files()]
    assert store.compact() == {"copied_bytes": 30, "reclaimed_bytes": 120,
                               "live_refs": 1}
    assert store.read_bytes("keep") == b"K" * 30
    assert store.dead_bytes() == 0
    assert store.generation() == gen_
    assert store.changes(gen_) == []
    store.append("later", b"l")
    assert store.generation() == gen_ + 1
    assert MetaLogStore(store.root).live_names() == ["keep", "later"]
    assert all(not os.path.exists(p) for p in old_logs)


def test_changes_feed_is_bounded_and_generation_ordered(tmp_path):
    store = store_at(tmp_path)
    for i in range(5):
        store.append(f"n{i}", b"x")
    store.tombstone("n2")
    rows = store.changes(0)
    assert [r.generation for r in rows] == sorted(r.generation
                                                  for r in rows)
    assert [(r.name, r.tombstone) for r in rows if r.name == "n2"] \
        == [("n2", True)]
    assert len(store.changes(0, limit=2)) == 2
    cursor = rows[-1].generation
    assert store.changes(cursor) == []
    store.append("n9", b"y")
    assert [r.name for r in store.changes(cursor)] == ["n9"]


def test_torn_tail_ignored_and_terminated_garbage_skipped(tmp_path):
    store = store_at(tmp_path)
    store.append("a", b"ref-a")
    with open(store.journal_path(), "ab") as f:
        f.write(b"not json at all\n")
    store.append("b", b"ref-b")
    with open(store.journal_path(), "ab") as f:
        f.write(b'{"o":"p","n":"torn","g":9')
    cold = MetaLogStore(store.root)
    assert cold.live_names() == ["a", "b"]
    cold.append("c", b"ref-c")
    assert cold.live_names() == ["a", "b", "c"]
    assert MetaLogStore(store.root).live_names() == ["a", "b", "c"]
    assert store.live_names() == ["a", "b", "c"]
    assert jax_meta_log.MetaLogStore(store.root).live_names() == \
        ["a", "b", "c"]


def test_concurrent_appends_from_two_instances(tmp_path):
    root = str(tmp_path / "m")
    a, b = MetaLogStore(root), MetaLogStore(root)
    errors = []

    def writer(store, prefix):
        try:
            for i in range(20):
                store.append(f"{prefix}/{i:02d}",
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
    assert len(a.live_names()) == len(b.live_names()) == 40
    assert a.read_bytes("b/07") == b"b7" * 10
    gens = [r.generation for r in a.changes(0, limit=100)]
    assert len(gens) == len(set(gens)) == 40


APPENDER = """
import sys
from {pkg}.cluster.meta_log import MetaLogStore
store = MetaLogStore(sys.argv[1])
for i in range(25):
    store.append(f"{tag}/{{i}}", b"from-{tag}-%d" % i)
print(len(store.live_names()))
"""


def test_cross_process_append_is_flock_serialized(tmp_path):
    """Two real processes, one per package, each under its own timeout,
    append to one store; the parent's store sees all 51 refs and every
    generation exactly once."""
    root = str(tmp_path / "m")
    parent = MetaLogStore(root)
    parent.append("parent/0", b"from-parent")
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
        assert 26 <= int(out) <= 51
    assert len(parent.live_names()) == 51
    assert parent.read_bytes("t/7") == b"from-t-7"
    assert parent.read_bytes("j/24") == b"from-j-24"
    gens = [r.generation for r in parent.changes(0, limit=100)]
    assert sorted(gens) == list(range(1, 52))


def test_namespace_questions_touch_no_dirents(tmp_path, monkeypatch):
    store = store_at(tmp_path)
    for i in range(50):
        store.append(f"d{i % 5}/n{i:02d}", b"x" * 20,
                     hashes=[f"sha256-{i:064d}"],
                     nodes=[["local", f"/n{i % 3}"]])
    store.generation()
    calls = {"n": 0}

    def counting(real):
        def inner(*a, **kw):
            calls["n"] += 1
            return real(*a, **kw)
        return inner

    monkeypatch.setattr(os, "listdir", counting(os.listdir))
    monkeypatch.setattr(os, "scandir", counting(os.scandir))
    assert len(store.live_names()) == 50
    assert len(store.prefix_names("d3")) == 10
    assert store.list_children("d0")[0] == "directory"
    assert len(store.index_meta()) == 50
    assert store.changes(0, limit=10)
    assert calls["n"] == 0


# ---- the index projection ----

def test_projection_roundtrips_append_compact_and_cold_reload(tmp_path):
    store = store_at(tmp_path)
    store.append("a", b"ref-a", hashes=["sha256-" + "0" * 64],
                 nodes=[["local", "/d0"], ["http", "node:8080"]])
    rows = store.index_meta()
    assert rows == [("a", ("sha256-" + "0" * 64,),
                     (("local", "/d0"), ("http", "node:8080")))]
    store.compact()
    assert store.index_meta() == rows
    assert MetaLogStore(store.root).index_meta() == rows
    assert jax_meta_log.MetaLogStore(store.root).index_meta() == rows


@pytest.mark.parametrize("name", ["cluster_placement", "slab_placement",
                                  "block_digests", "pm_msr_placement"])
def test_extract_index_meta_equals_jax_on_goldens(name):
    with open(os.path.join(gen.GOLDEN_DIR, f"{name}.yaml")) as f:
        payload = yaml.safe_load(f)
    hashes, nodes = meta_log.extract_index_meta(payload)
    assert (hashes, nodes) == jax_meta_log.extract_index_meta(payload)
    assert hashes == [f"sha256-{c['sha256']}"
                      for part in payload["parts"]
                      for c in part["data"] + part["parity"]]
    assert meta_log.extract_index_meta({"foreign": 1}) == (None, None)
    assert meta_log.extract_index_meta(None) == (None, None)


def test_namespace_fast_paths_fall_back_on_missing_projection(tmp_path):
    metadata = MetadataLog(path=str(tmp_path / "m"))
    store = metadata.store
    store.append("a", b"x", hashes=["sha256-" + "1" * 64],
                 nodes=[["local", "/d0"]])

    async def scan():
        return (await metadata.namespace_nodes(),
                await metadata.namespace_hashes())

    assert run(scan()) == ([("a", (("local", "/d0"),))],
                           [("a", ("sha256-" + "1" * 64,))])
    store.append("foreign", b"y")
    assert run(scan()) == (None, None)
    store.tombstone("foreign")
    nodes, hashes = run(scan())
    assert nodes is not None and hashes is not None


# ---- the async MetadataStore surface ----

def test_metadata_log_store_contract(tmp_path):
    metadata = metadata_from_obj({"type": "meta-log", "format": "json",
                                  "path": str(tmp_path / "m")})
    assert isinstance(metadata, MetadataLog)
    assert metadata.to_obj() == {"type": "meta-log", "format": "json",
                                 "path": str(tmp_path / "m")}

    async def roundtrip():
        await metadata.write("dir/a", {"k": 1})
        await metadata.write("dir/b", {"k": 2})
        assert await metadata.read("dir/a") == {"k": 1}
        listed = await metadata.list("dir")
        assert [(e.kind, e.path) for e in listed] == [
            ("directory", "dir"), ("file", "dir/a"), ("file", "dir/b")]
        assert [(e.kind, e.path) for e in await metadata.list(".")] == [
            ("directory", "."), ("directory", "dir")]
        with pytest.raises(MetadataReadError):
            await metadata.list("nope")
        assert await metadata.list_files_recursive() == ["dir/a", "dir/b"]
        objs = await metadata.read_objs(["dir/b", "ghost", "dir/a"])
        assert objs == [("dir/b", {"k": 2}), ("dir/a", {"k": 1})]
        assert await metadata.generation() == 2
        assert [r.name for r in await metadata.changes(1)] == ["dir/b"]
        await metadata.delete("dir/a")
        with pytest.raises(MetadataReadError):
            await metadata.read("dir/a")
        with pytest.raises(MetadataReadError):
            await metadata.delete("dir/a")
        assert await metadata.namespace_snapshot() == [("dir/b", {"k": 2})]
        assert (await metadata.compact())["live_refs"] == 1

    run(roundtrip())


def test_env_override_rebuilds_path_stores(tmp_path, monkeypatch):
    spec = {"type": "path", "path": str(tmp_path / "m")}
    monkeypatch.setenv(tunables.METADATA_KIND_ENV, "meta-log")
    assert isinstance(metadata_from_obj(dict(spec)), MetadataLog)
    assert isinstance(metadata_from_obj(dict(spec, put_script="true")),
                      MetadataPath)
    monkeypatch.setenv(tunables.METADATA_KIND_ENV, "bogus")
    assert isinstance(metadata_from_obj(dict(spec)), MetadataPath)


def cluster_spec(tmp_path, cache_bytes=0, backend="torch"):
    for i in range(3):
        os.makedirs(tmp_path / f"ssd{i}", exist_ok=True)
    spec = {
        "destinations": {"ssd": [{"location": str(tmp_path / f"ssd{i}")}
                                 for i in range(3)]},
        "metadata": {"type": "meta-log", "format": "yaml",
                     "path": str(tmp_path / "meta")},
        "profiles": {"default": {
            "data": 2, "parity": 1, "chunk_size": 12,
            "rules": {"ssd": {"minimum": 0, "maximum": None,
                              "ideal": 3}}}},
        "tunables": {"backend": backend},
    }
    if cache_bytes:
        spec["tunables"]["cache_bytes"] = cache_bytes
    return spec


def test_generation_fencing_vs_file_ref_lru(tmp_path):
    spec = cluster_spec(tmp_path, cache_bytes=1 << 20)

    async def main():
        writer = Cluster.from_obj(spec)
        reader = Cluster.from_obj(spec)
        await writer.write_file("f", aio.BytesReader(b"one" * 400),
                                writer.get_profile())
        first = await reader.get_file_ref("f")
        assert await reader.get_file_ref("f") is first
        await writer.write_file("f", aio.BytesReader(b"two" * 500),
                                writer.get_profile())
        assert await writer.get_file_ref("f") is not first
        reader._file_refs.clear()
        reader._file_ref_gen += 1
        fresh = await reader.get_file_ref("f")
        assert fresh.length == 1500
        assert await read_back(reader, "f") == b"two" * 500

    run(main())


# ---- the golden and the other package ----

def test_cluster_writes_the_meta_log_placement_golden(tmp_path,
                                                      monkeypatch):
    """tests/golden/generate.py's fixture 7 through the port's Cluster:
    the reference published through the meta-log and read back."""
    monkeypatch.chdir(tmp_path)
    for i in range(5):
        os.mkdir(f"d{i}")
    spec = gen.cluster_spec("meta")
    spec["metadata"] = {"type": "meta-log", "format": "yaml",
                        "path": "meta"}
    cluster = Cluster.from_obj(spec)

    async def main():
        ref = await (cluster.get_file_writer(cluster.get_profile())
                     .write(aio.BytesReader(gen.payload(30_000, 3))))
        await cluster.metadata.write("golden/ref", ref.to_obj())
        return await cluster.metadata.read("golden/ref")

    assert gen.dump(run(main())) == golden("meta_log_placement")
    with open("meta/refs-000001.log", "rb") as f:
        text = f.read().decode()
    assert gen.dump(yaml.safe_load(text)) == golden("meta_log_placement")


@pytest.mark.parametrize("name", ["block_digests", "slab_placement",
                                  "pm_msr_placement"])
def test_goldens_round_trip_through_the_meta_log(tmp_path, name):
    """A golden reference published through the port's meta-log reads
    back equal to the golden, and the log holds the bytes the JAX
    package's store writes for it."""
    from chunky_bits_tpu.cluster.metadata import \
        MetadataFormat as JaxFormat

    obj = yaml.safe_load(golden(name))
    ours = MetadataLog(str(tmp_path / "ours"), MetadataFormat("yaml"))
    theirs = jax_meta_log.MetadataLog(str(tmp_path / "theirs"),
                                      JaxFormat("yaml"))
    run(ours.write("g/ref", obj))
    run(theirs.write("g/ref", obj))
    assert gen.dump(run(ours.read("g/ref"))) == golden(name)
    assert ours.store.read_bytes("g/ref") == \
        theirs.store.read_bytes("g/ref")
    assert ours.store.index_meta() == theirs.store.index_meta()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_meta_log_cluster_opens_in_the_other_package(tmp_path, writer):
    """A meta-log cluster written (and tombstoned, and compacted) by one
    package opens in the other: equal index entries and ref bytes, equal
    listings, equal reads; the other package then publishes onto it."""
    from chunky_bits_tpu.cluster import Cluster as JaxCluster

    spec = cluster_spec(tmp_path)
    ours = Cluster.from_obj(spec)
    theirs = JaxCluster.from_obj(dict(spec, tunables={"backend": "numpy"}))
    first, second = (ours, theirs) if writer == "port" else (theirs, ours)
    blobs = {f"d/{i}": payload_of(3000 + 500 * i, i) for i in range(4)}

    async def main():
        for name, data in blobs.items():
            await first.write_file(name, aio.BytesReader(data),
                                   first.get_profile())
        await first.metadata.delete("d/1")
        del blobs["d/1"]
        await first.metadata.compact()
        a, b = ours.metadata.store, theirs.metadata.store
        assert a.snapshot_entries() == b.snapshot_entries()
        assert a.index_meta() == b.index_meta()
        assert a.generation() == b.generation()
        for name in blobs:
            assert a.read_bytes(name) == b.read_bytes(name)
            assert await read_back(second, name) == blobs[name]
        assert [(e.kind, e.path) for e in await second.list_files("d")] \
            == [(e.kind, e.path) for e in await first.list_files("d")]
        await second.write_file("e", aio.BytesReader(b"late" * 999),
                                second.get_profile())
        assert await read_back(first, "e") == b"late" * 999

    run(main())


# ---- durability through the fsio seam ----

def test_publish_fsyncs_log_then_journal_before_returning(tmp_path):
    store = store_at(tmp_path)
    rec = fsio.RecordingFsProvider(store.root)
    prev = fsio.install(rec)
    try:
        store.append("a", b"first")
        first = [(op.op, os.path.basename(op.path)) for op in rec.ops
                 if op.op in ("write", "fsync", "fsync_dir")]
        del rec.ops[:]
        store.append("b", b"second")
        second = [(op.op, os.path.basename(op.path)) for op in rec.ops
                  if op.op in ("write", "fsync", "fsync_dir")]
        del rec.ops[:]
        store.tombstone("a")
        tomb = [op.op for op in rec.ops if op.op in ("fsync", "fsync_dir")]
    finally:
        fsio.install(prev)
    log = "refs-000001.log"
    assert first == [("write", log), ("fsync", log),
                     ("write", "meta.jsonl"), ("fsync", "meta.jsonl"),
                     ("fsync_dir", ".")]
    # no file created: the data and journal fsyncs cover the append
    assert second == first[:4]
    assert tomb == ["fsync"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_failing_fsync_aborts_the_publish(tmp_path, pkg):
    """A failing fsync of the log or the journal raises out of the
    publish (no acknowledgment; a line written before the failed journal
    fsync is not durable and may or may not survive), and a short log
    append truncates its tail.  Both packages end in the same state."""
    from chunky_bits_tpu.utils import fsio as jax_fsio

    mod, seam = ((meta_log, fsio) if pkg == "port"
                 else (jax_meta_log, jax_fsio))
    store = mod.MetaLogStore(str(tmp_path / "m"))
    store.append("a", b"ok")
    for fault in (seam.FaultyFsProvider("fsync", path_suffix=".log"),
                  seam.FaultyFsProvider("fsync", path_suffix="meta.jsonl"),
                  seam.FaultyFsProvider("write", path_suffix=".log",
                                        short_bytes=3)):
        prev = seam.install(fault)
        try:
            with pytest.raises(OSError):
                store.append("b", b"never acknowledged")
        finally:
            seam.install(prev)
        assert fault.fired == 1
    # a failed log fsync or short write truncates its tail; the failed
    # journal fsync left its (unacknowledged) line and log bytes
    assert os.path.getsize(store.log_path("refs-000001.log")) == \
        len(b"ok") + len(b"never acknowledged")
    store.append("d", b"after")
    cold = MetaLogStore(store.root)
    assert cold.live_names() == ["a", "b", "d"]
    assert cold.read_bytes("d") == b"after"
