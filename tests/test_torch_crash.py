"""The port's crash-consistency harness (``chunky_bits_tpu_torch/sim/
crash.py``), held against ``tests/test_crash.py``,
``tests/test_crash_consistency.py`` and the JAX package's harness.

The mirror of the reference's tests: the filesystem seam's mechanics, the
replayer's failure models, every crash point of the eight storage-plane
mutations recovering clean and deterministically, the negative control (a
neutered directory fsync must go red), scripted live faults, the stale-temp
reapers, ``scrub --once`` converging a cluster's crash images, the fabric's
torn writes, and a ``cp`` killed mid-ingest leaving no torn state.

Across the packages, at seed 0 in one workdir path: ``matrix_digest``, the
op counts and every ``CrashVerdict`` equal the JAX package's, mutation by
mutation, and ``run_cluster_recovery``'s images give equal verdicts.  The
digest hashes the normalized op stream, so this also shows that the port's
slab store, meta-log, metadata and chunk publication make the same
durability ops in the same order.
"""

from __future__ import annotations

import asyncio
import errno
import hashlib
import io
import os
import shutil
import signal
import subprocess
import sys
import time

import pytest
import torch
import yaml

from chunky_bits_tpu.sim import crash as jcrash
from chunky_bits_tpu_torch.cli.main import main as port_main
from chunky_bits_tpu_torch.file.slab import SlabStore, SlabStoreError
from chunky_bits_tpu_torch.sim import crash
from chunky_bits_tpu_torch.utils import fsio
from tests.test_torch_cli import call
from tests.test_torch_file import bounded

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _restore_provider(monkeypatch):
    """Every test leaves the passthrough provider installed, whatever it
    broke; clusters name no backend, so the CPU default is ``torch``."""
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    fsio.install(None)


# ---- seam mechanics ----

def test_passthrough_provider_is_default_and_restores(tmp_path):
    assert fsio.active() is fsio.system_provider()
    recorder = fsio.RecordingFsProvider(str(tmp_path))
    previous = fsio.install(recorder)
    assert previous is fsio.system_provider()
    assert fsio.active() is recorder
    fsio.install(None)
    assert fsio.active() is fsio.system_provider()


def test_passthrough_open_is_the_builtin_file(tmp_path):
    path = str(tmp_path / "x")
    with fsio.open(path, "wb") as f:
        f.write(b"abc")
    with open(path, "rb") as f:
        assert f.read() == b"abc"
    with fsio.open(path, "ab") as f:
        assert isinstance(f, io.BufferedWriter)


def test_recording_captures_op_stream_and_scopes_to_root(tmp_path):
    root = tmp_path / "in"
    outside = tmp_path / "out"
    root.mkdir()
    outside.mkdir()
    recorder = fsio.RecordingFsProvider(str(root))
    fsio.install(recorder)
    try:
        with fsio.open(str(root / "a"), "wb") as f:
            f.write(b"payload")
            fsio.fsync(f)
        fsio.replace(str(root / "a"), str(root / "b"))
        fsio.fsync_dir(str(root))
        with fsio.open(str(outside / "c"), "wb") as f:
            f.write(b"elsewhere")
        with fsio.open(str(root / "b"), "rb") as f:
            assert f.read() == b"payload"
    finally:
        fsio.install(None)
    kinds = [(op.op, op.path) for op in recorder.ops]
    assert kinds == [
        ("open", "a"), ("write", "a"), ("flush", "a"), ("fsync", "a"),
        ("close", "a"), ("replace", "b"), ("fsync_dir", "."),
    ]
    assert recorder.ops[1].data == b"payload"
    assert recorder.ops[5].aux == "a"


def _record_simple(root, body):
    os.makedirs(root, exist_ok=True)
    return crash.record_mutation(str(root), body)


def test_replayer_powercut_drops_unsynced_writes(tmp_path):
    root, snap, img = tmp_path / "r", tmp_path / "snap", tmp_path / "img"
    root.mkdir()
    (root / "old").write_bytes(b"durable")
    shutil.copytree(root, snap)

    def body():
        with fsio.open(str(root / "new"), "wb") as f:
            f.write(b"unsynced")
            f.flush()

    ops = _record_simple(root, body)
    rep = crash.OpReplayer(str(snap))
    rep.build(ops, len(ops), "flush", str(img))
    assert (img / "new").read_bytes() == b"unsynced"
    assert (img / "old").read_bytes() == b"durable"
    shutil.rmtree(img)
    rep.build(ops, len(ops), "powercut", str(img))
    assert (img / "new").read_bytes() == b""
    assert (img / "old").read_bytes() == b"durable"
    shutil.rmtree(img)
    rep.build(ops, len(ops), "powercut-meta", str(img))
    assert not (img / "new").exists()


def test_replayer_fsync_and_dir_fsync_make_publication_durable(tmp_path):
    root, snap, img = tmp_path / "r", tmp_path / "snap", tmp_path / "img"
    root.mkdir()
    (root / "t").write_bytes(b"old")
    shutil.copytree(root, snap)

    def body():
        with fsio.open(str(root / "t.tmp.1.00000000"), "wb") as f:
            f.write(b"new")
            fsio.fsync(f)
        fsio.replace(str(root / "t.tmp.1.00000000"), str(root / "t"))
        fsio.fsync_dir(str(root))

    ops = _record_simple(root, body)
    rep = crash.OpReplayer(str(snap))
    rep.build(ops, len(ops), "powercut-meta", str(img))
    assert (img / "t").read_bytes() == b"new"
    shutil.rmtree(img)
    rep.build(ops, len(ops) - 1, "powercut-meta", str(img))
    assert (img / "t").read_bytes() == b"old"


def test_replayer_torn_write_cuts_final_write(tmp_path):
    root, snap, img = tmp_path / "r", tmp_path / "snap", tmp_path / "img"
    root.mkdir()
    shutil.copytree(root, snap)

    def body():
        with fsio.open(str(root / "j"), "ab") as f:
            f.write(b"0123456789")
            f.flush()

    ops = _record_simple(root, body)
    write_k = next(i for i, op in enumerate(ops) if op.op == "write")
    rep = crash.OpReplayer(str(snap))
    rep.build(ops, write_k + 1, "torn", str(img), torn=4)
    assert (img / "j").read_bytes() == b"0123"


# ---- the crash matrix: every point recovers, deterministically ----

@pytest.mark.parametrize("mutation", sorted(crash.MUTATIONS))
def test_crash_matrix_mutation_recovers_clean(tmp_path, mutation):
    result = bounded(lambda: crash.run_matrix(str(tmp_path), seed=0,
                                              mutations=[mutation]))
    assert result.verdicts, "no crash images enumerated"
    failed = result.failed()
    assert not failed, [v.to_obj() for v in failed[:5]]
    assert result.ops_by_mutation[mutation] >= 3
    modes = {v.mode for v in result.verdicts}
    assert {"kill", "flush", "powercut", "powercut-meta"} <= modes


def test_crash_matrix_is_deterministic(tmp_path):
    picks = ["slab_append", "metadata_publish"]
    first = bounded(lambda: crash.run_matrix(str(tmp_path / "a"), seed=7,
                                             mutations=picks))
    second = bounded(lambda: crash.run_matrix(str(tmp_path / "b"), seed=7,
                                              mutations=picks))
    assert first.digest == second.digest
    assert [v.to_obj() for v in first.verdicts] \
        == [v.to_obj() for v in second.verdicts]


def test_crash_matrix_catches_a_dropped_dir_fsync(tmp_path, monkeypatch):
    """The negative control: with the directory fsync neutered, the
    completed-publication power-cut images must go red."""
    monkeypatch.setattr(fsio.FsProvider, "fsync_dir",
                        lambda self, path: None)
    monkeypatch.setattr(fsio.RecordingFsProvider, "fsync_dir",
                        lambda self, path: None, raising=False)
    result = bounded(lambda: crash.run_matrix(
        str(tmp_path), seed=0, mutations=["metadata_publish"]))
    failed = result.failed()
    assert failed, "neutered fsync_dir went undetected"
    assert any(v.mode == "powercut-meta" and "acknowledged" in
               " ".join(v.violations) for v in failed)


def test_unknown_mutation_fails_loudly(tmp_path):
    with pytest.raises(ValueError, match="unknown mutation"):
        crash.run_matrix(str(tmp_path), mutations=["heat_death"])


# ---- the port against the JAX package ----

def test_matrix_equals_reference(tmp_path):
    """Seed 0, one workdir path: the digest, the op counts and every
    verdict equal the JAX package's, mutation by mutation."""
    workdir = str(tmp_path / "matrix")
    ref = bounded(lambda: jcrash.run_matrix(workdir, seed=0))
    got = bounded(lambda: crash.run_matrix(workdir, seed=0))
    assert sorted(got.ops_by_mutation) == sorted(crash.MUTATIONS)
    assert got.ops_by_mutation == ref.ops_by_mutation
    for name in sorted(crash.MUTATIONS):
        mine = [v.to_obj() for v in got.verdicts if v.mutation == name]
        theirs = [v.to_obj() for v in ref.verdicts if v.mutation == name]
        assert mine == theirs, name
    assert got.rows() == ref.rows()
    assert got.crash_points() == ref.crash_points()
    assert got.digest == ref.digest
    assert got.ok()


@pytest.mark.parametrize("points", ["smoke", "full"])
def test_cluster_recovery_equals_reference(tmp_path, points):
    workdir = str(tmp_path / "cluster")
    ref = bounded(lambda: jcrash.run_cluster_recovery(workdir, seed=0,
                                                      points=points))
    got = bounded(lambda: crash.run_cluster_recovery(workdir, seed=0,
                                                     points=points))
    assert [v.to_obj() for v in got] == [v.to_obj() for v in ref]
    assert got and all(v.ok for v in got), [v.to_obj() for v in got]


# ---- scripted live faults ----

def _fresh_slab_with_chunks(root, n=2):
    store = SlabStore(str(root))
    expected = {}
    for i in range(n):
        payload = bytes([i]) * (300 + i)
        name = hashlib.sha256(payload).hexdigest()
        store.append(name, payload)
        expected[name] = payload
    return store, expected


def test_enospc_short_write_truncates_partial_tail(tmp_path):
    store, expected = _fresh_slab_with_chunks(tmp_path / "s")
    slab_file = os.path.join(store.root, store.slab_files()[-1])
    size_before = os.path.getsize(slab_file)
    fsio.install(fsio.FaultyFsProvider(
        "write", path_suffix=".slab", errno_code=errno.ENOSPC,
        short_bytes=17))
    try:
        with pytest.raises(OSError):
            store.append("a" * 64, b"x" * 4096)
    finally:
        fsio.install(None)
    assert os.path.getsize(slab_file) == size_before
    fresh = SlabStore(store.root)
    assert sorted(fresh.live_names()) == sorted(expected)
    payload = b"after-enospc"
    name = hashlib.sha256(payload).hexdigest()
    ext = fresh.append(name, payload)
    assert ext.offset == size_before
    assert fresh.pread(name) == payload
    for k, v in expected.items():
        assert fresh.pread(k) == v


def test_failed_fsync_aborts_compaction(tmp_path):
    store, expected = _fresh_slab_with_chunks(tmp_path / "s", n=3)
    store.mark_dead(sorted(expected)[0])
    with open(store.journal_path(), "rb") as f:
        journal_before = f.read()
    fsio.install(fsio.FaultyFsProvider("fsync"))
    try:
        with pytest.raises((OSError, SlabStoreError)):
            store.compact()
    finally:
        fsio.install(None)
    with open(store.journal_path(), "rb") as f:
        assert f.read() == journal_before
    fresh = SlabStore(store.root)
    for k in sorted(expected)[1:]:
        assert fresh.pread(k) == expected[k]
    assert fresh.dead_bytes() > 0
    fresh.compact()
    again = SlabStore(store.root)
    assert again.dead_bytes() == 0
    for k in sorted(expected)[1:]:
        assert again.pread(k) == expected[k]


def test_failed_dir_fsync_aborts_compaction_state_flip(tmp_path):
    store, expected = _fresh_slab_with_chunks(tmp_path / "s", n=3)
    store.mark_dead(sorted(expected)[0])
    fsio.install(fsio.FaultyFsProvider("fsync_dir"))
    try:
        with pytest.raises(OSError):
            store.compact()
    finally:
        fsio.install(None)
    fresh = SlabStore(store.root)
    for k in sorted(expected)[1:]:
        assert fresh.pread(k) == expected[k]


def test_failed_fsync_aborts_metadata_publication(tmp_path):
    from chunky_bits_tpu_torch.cluster.metadata import MetadataPath
    from chunky_bits_tpu_torch.errors import MetadataReadError
    from chunky_bits_tpu_torch.file.location import is_publish_temp

    meta = MetadataPath(str(tmp_path))
    asyncio.run(meta.write("obj", {"v": 1}))
    fsio.install(fsio.FaultyFsProvider("fsync"))
    try:
        with pytest.raises(MetadataReadError):
            asyncio.run(meta.write("obj", {"v": 2}))
    finally:
        fsio.install(None)
    assert asyncio.run(meta.read("obj")) == {"v": 1}
    assert not [f for f in os.listdir(tmp_path) if is_publish_temp(f)]


def test_metadata_write_reaps_stale_temps_only(tmp_path):
    from chunky_bits_tpu_torch.cluster.metadata import (STALE_TEMP_SECONDS,
                                                        MetadataPath)
    from chunky_bits_tpu_torch.file.location import publish_temp_name

    asyncio.run(MetadataPath(str(tmp_path)).write("obj", {"v": 1}))
    stale = publish_temp_name(str(tmp_path / "obj"))
    fresh = publish_temp_name(str(tmp_path / "obj"))
    for path in (stale, fresh):
        with open(path, "w") as f:
            f.write("{}")
    old = time.time() - STALE_TEMP_SECONDS - 10
    os.utime(stale, (old, old))
    meta = MetadataPath(str(tmp_path))
    asyncio.run(meta.write("obj", {"v": 2}))
    assert not os.path.exists(stale)
    assert os.path.exists(fresh)
    assert asyncio.run(meta.read("obj")) == {"v": 2}
    late = publish_temp_name(str(tmp_path / "obj"))
    with open(late, "w") as f:
        f.write("{}")
    os.utime(late, (old, old))
    asyncio.run(meta.write("obj", {"v": 3}))
    assert os.path.exists(late)
    asyncio.run(MetadataPath(str(tmp_path)).write("obj", {"v": 4}))
    assert not os.path.exists(late)


def test_gc_walk_reaps_stale_publish_temp(tmp_path):
    """find-unused-hashes removes an aged publication temp from a hash
    dir (the CLI in this process)."""
    from chunky_bits_tpu_torch.file.location import publish_temp_name

    disk = tmp_path / "disk0"
    disk.mkdir()
    (tmp_path / "metadata").mkdir()
    (tmp_path / "config.yaml").write_text("")
    config = tmp_path / "cluster.yaml"
    config.write_text(yaml.safe_dump({
        "destinations": [{"location": str(disk)}],
        "metadata": {"type": "path", "format": "yaml",
                     "path": str(tmp_path / "metadata")},
        "profiles": {"default": {"data": 1, "parity": 1,
                                 "chunk_size": 12}},
    }))
    temp = publish_temp_name(str(disk / ("sha256-" + "a" * 64)))
    with open(temp, "wb") as f:
        f.write(b"half-published")
    old = time.time() - 3600
    os.utime(temp, (old, old))
    _out, err = call(port_main, tmp_path, "find-unused-hashes", "--remove",
                     f"{config}#.", "--", str(disk))
    assert not os.path.exists(temp)
    assert "Stale publish temp" in err


# ---- cluster recovery: crash image + scrub --once -> Valid ----

def test_scrub_once_converges_powercut_images(tmp_path):
    verdicts = bounded(lambda: crash.run_cluster_recovery(
        str(tmp_path / "w"), seed=0, points="smoke"))
    assert len(verdicts) >= 2
    failed = [v for v in verdicts if not v.ok]
    assert not failed, [v.to_obj() for v in failed]


# ---- sim fabric disk faults ----

def test_sim_node_torn_write_budget():
    from chunky_bits_tpu_torch.sim.fabric import LatencyModel, SimFabric

    fabric = SimFabric("crashtest", 1, zones=("z",), seed=0,
                       latency=LatencyModel(median_ms=0.01))
    try:
        node = fabric.nodes["n0000"]
        node.faults.torn_put_bytes = 3
        node.faults.torn_put_remaining = 1

        async def drive():
            await node.write("tiny", b"ab")
            assert node.faults.torn_put_remaining == 1
            await node.write("c", b"0123456789")
            first = bytes(node.store["c"])
            await node.write("c", b"0123456789")
            return first, bytes(node.store["c"])

        torn, healed = bounded(lambda: asyncio.run(drive()))
        assert torn == b"012"
        assert healed == b"0123456789"
        assert node.torn_writes == 1
        assert node.stats()["torn_writes"] == 1
    finally:
        fabric.close()


@pytest.mark.slow
def test_disk_corruption_storm_scenario(tmp_path):
    from chunky_bits_tpu_torch.sim.scenario import (fresh_workdir,
                                                    run_scenario)

    result = bounded(lambda: run_scenario(
        "disk_corruption_storm", nodes=12, seed=0,
        workdir=fresh_workdir(str(tmp_path / "w")), objects=6))
    assert result.ok(), result.to_obj()["verdicts"]
    assert result.verdicts["torn_writes_ridden_out"]
    assert result.verdicts["corruption_detected"]


# ---- a cp killed mid-ingest (tests/test_crash_consistency.py) ----

def _chunks_on_disk(disks):
    return [os.path.join(d, f) for d in disks for f in os.listdir(d)]


def test_sigkill_mid_cp_leaves_no_torn_state(tmp_path):
    """``python -m chunky_bits_tpu_torch cp`` killed as soon as its first
    chunk lands leaves no metadata entry (``cat`` fails cleanly), its
    orphaned chunks are reclaimed by find-unused-hashes once aged, and a
    retry of the same name succeeds end to end."""
    disks = []
    for i in range(5):
        d = tmp_path / f"disk{i}"
        d.mkdir()
        disks.append(str(d))
    (tmp_path / "metadata").mkdir()
    (tmp_path / "config.yaml").write_text("")
    yaml_path = tmp_path / "cluster.yaml"
    yaml_path.write_text(yaml.safe_dump({
        "destinations": [{"location": d} for d in disks],
        "metadata": {"type": "path", "format": "yaml",
                     "path": str(tmp_path / "metadata")},
        "profiles": {"default": {"data": 3, "parity": 2,
                                 "chunk_size": 12}},
    }))
    src = tmp_path / "input.bin"
    src.write_bytes(os.urandom(8 << 20))
    env = dict(os.environ, PYTHONPATH=REPO)

    proc = subprocess.Popen(
        [sys.executable, "-m", "chunky_bits_tpu_torch", "cp", str(src),
         f"{yaml_path}#obj"], env=env, cwd=REPO,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            if _chunks_on_disk(disks):
                break
            if proc.poll() is not None:
                pytest.fail("cp finished before any chunk landed")
            time.sleep(0.002)
        else:
            pytest.fail("no chunk ever landed")
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()

    # no metadata entry: a read is a clean not-found
    assert not (tmp_path / "metadata" / "obj").exists()
    out, _err = call(port_main, tmp_path, "cat", f"{yaml_path}#obj", rc=1)
    assert out == b""

    # the orphans go once aged past the grace window
    orphans = _chunks_on_disk(disks)
    assert orphans, "kill landed after cleanup?"
    old = time.time() - 3600
    for p in orphans:
        os.utime(p, (old, old))
    call(port_main, tmp_path, "find-unused-hashes", "--remove",
         f"{yaml_path}#.", "--", *disks)
    assert not _chunks_on_disk(disks)

    # a retry of the same name succeeds end to end
    call(port_main, tmp_path, "cp", str(src), f"{yaml_path}#obj")
    out, _err = call(port_main, tmp_path, "cat", f"{yaml_path}#obj")
    assert hashlib.sha256(out).digest() \
        == hashlib.sha256(src.read_bytes()).digest()
