"""The port's cluster plane against the JAX package: config parsing, weighted
and zoned placement, metadata stores, failover, the device-backend
lifecycle, the backend aliases and pm-msr.

The assertions are those of ``tests/test_cluster.py``, ``test_failover.py``,
``test_tpu_cluster.py`` (lifecycle, wide stripe, resilver coalescing) and
``test_parallel.py::test_mesh_backend_cluster_lifecycle``, run on the
``torch`` backend and on the mesh backends over ``virtual_devices(8,
"cpu")``.  The golden ``cluster_placement.yaml`` and ``pm_msr_placement.yaml``
must come out byte-equal, and pm-msr's encode, degraded read and
``repair_batch`` must equal the JAX package's numpy path (tolerance 0).
Storage nodes that fail are local paths under a regular file, since the
port has no http scheme yet.
"""

import asyncio
import os
import pathlib
import random

import numpy as np
import pytest
import yaml

from chunky_bits_tpu.ops.backend import get_coder as jax_get_coder
from chunky_bits_tpu_torch.cluster import (Cluster, ClusterNodes,
                                           ClusterProfiles, MetadataGit,
                                           MetadataPath, Tunables,
                                           metadata_from_obj)
from chunky_bits_tpu_torch.errors import (ErasureError, FileReadError,
                                          FileWriteError, LocationParseError,
                                          MetadataReadError,
                                          NotEnoughAvailability,
                                          NotEnoughWriters, SerdeError)
from chunky_bits_tpu_torch.file import (AnyHash, FileIntegrity,
                                        FileReadBuilder, FileWriteBuilder)
from chunky_bits_tpu_torch.ops import backend, batching
from chunky_bits_tpu_torch.ops.backend import ErasureCoder, NumpyBackend
from chunky_bits_tpu_torch.ops.mesh_backend import MeshBackend
from chunky_bits_tpu_torch.parallel.backend import MeshCudaBackend
from chunky_bits_tpu_torch.utils import aio
from chunky_bits_tpu_torch.utils.virtualmesh import virtual_devices
from tests.golden import generate as gen
from tests.test_torch_file import golden, run

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
CPU8 = virtual_devices(8, "cpu")


@pytest.fixture(autouse=True)
def torch_default(monkeypatch):
    """Every unnamed backend is ``torch`` (the port's default is ``cuda``,
    which raises without a card); the port's knobs start unset."""
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    for knob in ("CODE", "HEDGE_MS", "READ_RETRIES", "CACHE_BYTES",
                 "METADATA_KIND", "REPAIR_BLOCK_BYTES", "STAGGER_SECONDS"):
        monkeypatch.delenv("CHUNKY_BITS_TORCH_" + knob, raising=False)


@pytest.fixture
def cpu_meshes(monkeypatch):
    """The mesh backends over 8 logical CPU devices, registered under the
    names a cluster YAML resolves to (``mesh``, ``cuda:<spec>`` under its
    canonical name and as spelled, as ``get_backend`` registers it)."""
    for spelled, be in (("mesh", MeshBackend(devices=CPU8)),
                        ("cuda:dp4,sp2",
                         MeshCudaBackend("dp4,sp2", devices=CPU8)),
                        ("cuda:tp4", MeshCudaBackend("tp4", devices=CPU8))):
        monkeypatch.setitem(backend._REGISTRY, be.name, be)
        monkeypatch.setitem(backend._REGISTRY, spelled, be)


def synthetic(n: int, seed: int = 0) -> bytes:
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def disks(root, n, prefix="disk"):
    out = []
    for i in range(n):
        d = root / f"{prefix}{i}"
        d.mkdir(parents=True)
        out.append(str(d))
    return out


def cluster_obj(root, dirs, d=3, p=2, chunk_size=12, **extra):
    meta = root / "meta"
    meta.mkdir(exist_ok=True)
    obj = {
        "destinations": [{"location": x} for x in dirs],
        "metadata": {"type": "path", "format": "yaml", "path": str(meta)},
        "profiles": {"default": {"data": d, "parity": p,
                                 "chunk_size": chunk_size}},
    }
    obj.update(extra)
    return obj


def make_cluster(tmp_path, repeat=99) -> Cluster:
    """The examples/test.yaml shape (tests/cluster.rs:63-103)."""
    repo = tmp_path / "repo"
    repo.mkdir(exist_ok=True)
    cluster = Cluster.from_obj(cluster_obj(tmp_path, [str(repo)],
                                           chunk_size=16))
    cluster.destinations.nodes[0].repeat = repeat
    return cluster


def broken_node(tmp_path) -> str:
    """A destination every write to fails: a directory path under a
    regular file."""
    blocker = tmp_path / "not-a-dir"
    blocker.write_bytes(b"")
    return str(blocker / "node")


# ---- config parsing ----

@pytest.mark.parametrize("name,refused", [
    ("local", None), ("weights", None), ("test", None), ("git", "http"),
    ("zones", "http"), ("tpu", "slab")])
def test_cluster_from_yaml_examples(name, refused):
    """Every example parses; ``refused`` names the scheme an example uses
    beyond ``path``.  ``http`` and ``slab`` are ported: those examples
    load with their destinations, serialized as the JAX package does."""
    from chunky_bits_tpu.cluster import Cluster as JaxCluster

    obj = yaml.safe_load((EXAMPLES / f"{name}.yaml").read_text())
    cluster = Cluster.from_obj(obj)
    assert cluster.get_profile() is not None
    if refused is not None:
        text = yaml.safe_dump(cluster.to_obj()["destinations"])
        assert f"{refused}:" in text
        assert text == yaml.safe_dump(
            JaxCluster.from_obj(obj).to_obj()["destinations"])


def test_zone_map_flattening():
    nodes = ClusterNodes.from_obj({
        "ssd": [{"location": "/mnt/ssd1"}, {"location": "/mnt/ssd2"}],
        "offsite": {"location": "/mnt/remote/repo"},
    })
    assert len(nodes) == 3
    zones = {str(n.location.location): n.zones for n in nodes}
    assert zones["/mnt/ssd1"] == {"ssd"}
    assert zones["/mnt/remote/repo"] == {"offsite"}


def test_profile_inheritance():
    profiles = ClusterProfiles.from_obj({
        "default": {
            "data": 3, "parity": 2, "chunk_size": 20,
            "rules": {"ssd": {"minimum": 1, "maximum": None, "ideal": 2}},
        },
        "lowlatency": {"parity": 0, "rules": {"ssd": None}},
        "wide": {"data": 10},
    })
    low = profiles.get("lowlatency")
    assert (low.data_chunks, low.parity_chunks) == (3, 0)
    assert low.zone_rules == {}  # null removes the inherited rule
    wide = profiles.get("wide")
    assert (wide.data_chunks, wide.parity_chunks) == (10, 2)
    assert wide.zone_rules["ssd"].ideal == 2
    assert profiles.get("DEFAULT") is profiles.get_default()
    assert profiles.get("missing") is None
    with pytest.raises(SerdeError):
        ClusterProfiles.from_obj({"custom": {"data": 1, "parity": 0}})


@pytest.mark.parametrize("profile,error", [
    ({"data": 5, "parity": 4, "code": "pm-msr"}, None),
    ({"data": 5, "parity": 2, "code": "pm-msr"}, "parity >= data-1"),
    ({"data": 3, "parity": 2, "code": "lrc"}, "must be one of"),
    ({"data": 0, "parity": 2}, "DataChunkCount"),
    ({"data": 3, "parity": 2, "chunk_size": 9}, "ChunkSize"),
])
def test_profile_code_and_sizes_validate_like_jax(profile, error):
    from chunky_bits_tpu.cluster import ClusterProfile as JaxProfile
    from chunky_bits_tpu.errors import SerdeError as JaxSerdeError
    from chunky_bits_tpu_torch.cluster import ClusterProfile

    if error is None:
        assert ClusterProfile.from_obj(profile).to_obj() \
            == JaxProfile.from_obj(profile).to_obj()
        return
    with pytest.raises(SerdeError, match=error):
        ClusterProfile.from_obj(profile)
    with pytest.raises(JaxSerdeError, match=error):
        JaxProfile.from_obj(profile)


def test_code_env_default_is_lenient(monkeypatch):
    from chunky_bits_tpu_torch.cluster import ClusterProfile

    monkeypatch.setenv("CHUNKY_BITS_TORCH_CODE", "pm-msr")
    # the JAX package's variable does not reconfigure the port
    monkeypatch.setenv("CHUNKY_BITS_TPU_CODE", "rs")
    fits = ClusterProfile.from_obj({"data": 3, "parity": 2,
                                    "chunk_size": 12})
    assert fits.get_code() == "pm-msr"
    narrow = ClusterProfile.from_obj({"data": 5, "parity": 2})
    assert narrow.get_code() == "rs"


# ---- the write and read paths ----

def test_cluster_write_read_and_list(tmp_path):
    cluster = make_cluster(tmp_path)
    payload = synthetic(1 << 18, seed=1)

    async def main():
        await cluster.write_file("some-file", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("some-file")
        assert ref.length == len(payload)
        assert await FileReadBuilder(ref).read_all() == payload
        reader = await cluster.read_file("some-file")
        chunks = []
        while (blk := await reader.read(1 << 20)):
            chunks.append(bytes(blk))
        assert b"".join(chunks) == payload
        names = {f.path for f in await cluster.list_files(".")
                 if f.is_file()}
        assert "some-file" in names

    run(main())


def test_not_enough_writers_via_repeat(tmp_path):
    """(tests/cluster.rs:122-143)"""
    cluster = make_cluster(tmp_path, repeat=3)  # 4 slots < 5 needed
    with pytest.raises(NotEnoughWriters):
        run(cluster.write_file("toobig", aio.BytesReader(synthetic(100000)),
                               cluster.get_profile()))


def test_delete_and_resilver(tmp_path):
    """(tests/cluster.rs:145-231): lose one data and one parity chunk of
    every part; Degraded, resilver, Valid, byte-identical."""
    cluster = make_cluster(tmp_path)
    payload = synthetic(1 << 19, seed=7)

    async def main():
        profile = cluster.get_profile()
        await cluster.write_file("resilver-me", aio.BytesReader(payload),
                                 profile)
        ref = await cluster.get_file_ref("resilver-me")
        deleted = 0
        for part in ref.parts:
            os.remove(part.data[0].locations[0].target)
            os.remove(part.parity[0].locations[0].target)
            deleted += 2
        verify = await ref.verify()
        assert verify.integrity() == FileIntegrity.DEGRADED
        assert verify.is_available() and not verify.is_ideal()
        report = await ref.resilver(cluster.get_destination(profile))
        assert report.integrity() == FileIntegrity.RESILVERED
        assert len(report.new_locations()) == deleted
        assert (await ref.verify()).integrity() == FileIntegrity.VALID
        assert await FileReadBuilder(ref).read_all() == payload

    run(main())


def test_write_profiler_bounds(tmp_path):
    """(tests/cluster.rs:233-251), and the report carries the cluster's
    location-health table."""
    cluster = make_cluster(tmp_path)

    async def main():
        report, _ref = await cluster.write_file_with_report(
            "profiled", aio.BytesReader(synthetic(1 << 18)),
            cluster.get_profile())
        assert 0 < report.average_write_duration() < 1.0
        assert report.total_bytes() > 0
        assert "Health<" in str(report)

    run(main())


def zoned_cluster(tmp_path, default_rules, **profiles):
    ssd = disks(tmp_path, 5, "ssd")
    hdd = disks(tmp_path, 5, "hdd")
    obj = cluster_obj(tmp_path, [], d=2, p=1, chunk_size=16)
    obj["destinations"] = {"ssd": [{"location": x} for x in ssd],
                           "hdd": [{"location": x} for x in hdd]}
    obj["profiles"]["default"]["rules"] = default_rules
    obj["profiles"].update(profiles)
    return Cluster.from_obj(obj)


@pytest.mark.parametrize("profile,rules,at_most", [
    (None, {"ssd": {"minimum": 0, "maximum": None, "ideal": 3}}, None),
    ("pinned", {}, None),
    (None, {"ssd": {"minimum": 0, "maximum": 1, "ideal": 0}}, 1),
])
def test_zone_rules(tmp_path, profile, rules, at_most):
    """ideal steers the first placements into a zone, minimum requires
    them, maximum caps a zone's shards per part."""
    cluster = zoned_cluster(tmp_path, rules, pinned={
        "rules": {"ssd": {"minimum": 3, "maximum": None, "ideal": 0}}})

    async def main():
        await cluster.write_file("x", aio.BytesReader(synthetic(100000, 2)),
                                 cluster.get_profile(profile))
        ref = await cluster.get_file_ref("x")
        for part in ref.parts:
            on_ssd = sum("/ssd" in c.locations[0].target
                         for c in part.data + part.parity)
            if at_most is None:
                assert on_ssd == len(part.data) + len(part.parity)
            else:
                assert on_ssd <= at_most

    run(main())


def test_parity_zero_profile(tmp_path):
    cluster = Cluster.from_obj(cluster_obj(tmp_path, disks(tmp_path, 4),
                                           p=0))
    payload = synthetic(30000, 3)

    async def main():
        await cluster.write_file("x", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("x")
        assert all(part.parity == [] and len(part.data) == 3
                   for part in ref.parts)
        assert await ref.read_builder().read_all() == payload
        assert (await ref.verify()).integrity() == FileIntegrity.VALID
        os.remove(ref.parts[0].data[0].locations[0].target)
        with pytest.raises(FileReadError):
            await (await cluster.get_file_ref("x")).read_builder() \
                .read_all()

    run(main())


def test_placement_is_hash_seeded_deterministic(tmp_path):
    """(writer.rs:80-85) identical content into identical fresh clusters
    lands every shard on the same nodes."""
    payload = synthetic(30000, 4)

    async def placements(root):
        dirs = disks(root, 6)
        cluster = Cluster.from_obj(cluster_obj(root, dirs))
        await cluster.write_file("x", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("x")
        return [next(i for i, d in enumerate(dirs)
                     if c.locations[0].target.startswith(d))
                for part in ref.parts for c in part.data + part.parity]

    assert run(placements(tmp_path / "a")) == run(placements(tmp_path / "b"))


# ---- metadata stores ----

def test_metadata_git(tmp_path):
    """MetadataGit commits every write and denies .git paths."""
    gitdir = tmp_path / "gitmeta"
    gitdir.mkdir()

    async def git(*args):
        proc = await asyncio.create_subprocess_exec(
            "git", *args, cwd=str(gitdir), stdout=asyncio.subprocess.PIPE)
        out, _ = await proc.communicate()
        assert proc.returncode == 0
        return out

    async def main():
        await git("init", "-q")
        await git("config", "user.email", "test@test")
        await git("config", "user.name", "test")
        meta = MetadataGit(str(gitdir))
        await meta.write("obj1", {"length": 1, "parts": []})
        assert (await meta.read("obj1"))["length"] == 1
        with pytest.raises(MetadataReadError):
            await meta.read(".git/config")
        assert b"Write obj1" in await git("log", "--oneline")

    run(main())


@pytest.mark.parametrize("script,fail,error", [
    ("touch {marker}", False, None),
    ("exit 3", True, "code 3"),
    ("kill -TERM $$", True, "signal 15"),
])
def test_metadata_put_script(tmp_path, script, fail, error):
    """A put_script runs after each write; with fail_on_script_error a
    nonzero exit and a signal death are reported apart."""
    meta_dir = tmp_path / "meta"
    meta_dir.mkdir()
    marker = tmp_path / "marker"
    meta = MetadataPath(str(meta_dir), put_script=script.format(
        marker=marker), fail_on_script_error=fail)
    write = meta.write("f", {"length": 0, "parts": []})
    if error is None:
        run(write)
        assert marker.exists()
        return
    with pytest.raises(MetadataReadError, match=error):
        run(write)


@pytest.mark.parametrize("obj,env", [
    ({"type": "meta-log", "path": "m"}, None),
    ({"kind": "meta-log", "path": "m"}, None),
    ({"type": "path", "path": "m"}, "meta-log"),
])
def test_meta_log_is_not_yet_ported(monkeypatch, obj, env):
    """The meta-log store is ported: the YAML tag, its ``kind:`` alias
    and ``$CHUNKY_BITS_TORCH_METADATA_KIND`` build it (the JAX variable
    does not)."""
    from chunky_bits_tpu_torch.cluster.meta_log import MetadataLog

    monkeypatch.setenv("CHUNKY_BITS_TPU_METADATA_KIND", "meta-log")
    if env:
        monkeypatch.setenv("CHUNKY_BITS_TORCH_METADATA_KIND", env)
        plain = dict(obj)
    else:
        plain = {"type": "path", "path": "m"}
    store = metadata_from_obj(obj)
    assert isinstance(store, MetadataLog)
    assert store.to_obj() == {"type": "meta-log", "format": "json-pretty",
                              "path": "m"}
    monkeypatch.delenv("CHUNKY_BITS_TORCH_METADATA_KIND", raising=False)
    assert isinstance(metadata_from_obj(plain), MetadataPath)
    # a put_script store stays a path store under the override
    assert isinstance(metadata_from_obj(
        {"type": "path", "path": "m", "put_script": "true"}), MetadataPath)


# ---- failover (tests/test_failover.py, with a broken local node) ----

def failing_cluster(tmp_path, n_good, n_bad=1, zones=False):
    bad = [broken_node(tmp_path)] + [
        str(tmp_path / "not-a-dir" / f"node{i}") for i in range(1, n_bad)]
    obj = cluster_obj(tmp_path, bad + disks(tmp_path, n_good))
    if zones:
        for i, node in enumerate(obj["destinations"]):
            node["zones"] = ["ssd"] if i == 0 else ["hdd"]
        obj["profiles"]["default"]["rules"] = {"ssd": {"ideal": 1}}
    return Cluster.from_obj(obj), bad


@pytest.mark.parametrize("zones", [False, True])
def test_write_fails_over_broken_node(tmp_path, zones):
    """One dead node (the ideal zone's only one, with ``zones``): the
    write succeeds, every shard lands on a healthy node, and the dead node
    was tried (failover, not avoidance)."""
    cluster, bad = failing_cluster(tmp_path, 5, zones=zones)
    payload = synthetic(30000, 21)

    async def main():
        ref = await cluster.write_file("x", aio.BytesReader(payload),
                                       cluster.get_profile())
        rows = {r.key[1]: r for r in
                cluster.health_scoreboard().stats().locations}
        assert rows[bad[0]].errors > 0, "dead node was never attempted"
        for part in ref.parts:
            for chunk in part.data + part.parity:
                assert all(not loc.target.startswith(bad[0])
                           for loc in chunk.locations)
        got = await (await cluster.get_file_ref("x")).read_builder() \
            .read_all()
        assert got == payload

    run(main())


def test_write_exhaustion_raises(tmp_path):
    """d+p=5 with 3 healthy slots: the retry loop exhausts and raises."""
    cluster, _bad = failing_cluster(tmp_path, 3, n_bad=2)
    with pytest.raises((FileWriteError, NotEnoughAvailability)):
        run(cluster.write_file("x", aio.BytesReader(synthetic(30000)),
                               cluster.get_profile()))


# ---- device backends (tests/test_tpu_cluster.py, test_parallel.py) ----

@pytest.mark.parametrize("name", ["torch", "jax:dp4,sp2", "mesh"])
def test_backend_cluster_lifecycle(tmp_path, cpu_meshes, name):
    """The erasure backend from the YAML: ingest (shards equal to the
    numpy oracle), degraded read, resilver, verify.  The device names
    engage the shared encode batcher and stage 8 parts a dispatch."""
    cluster = Cluster.from_obj(cluster_obj(
        tmp_path, disks(tmp_path, 7), d=4, p=2, chunk_size=14,
        tunables={"backend": name}))
    assert cluster.tunables.backend == name
    payload = synthetic(300000, 3)

    async def main():
        profile = cluster.get_profile()
        await cluster.write_file("f", aio.BytesReader(payload), profile)
        assert cluster.get_file_writer(profile).batch_parts == 8
        shared = cluster._encode_batchers.get(asyncio.get_running_loop())
        assert (shared is not None) == (name != "torch")
        ref = await cluster.get_file_ref("f")
        part = ref.parts[0]
        rows = [np.frombuffer(pathlib.Path(c.locations[0].target)
                              .read_bytes(), dtype=np.uint8)
                for c in part.data]
        oracle = ErasureCoder(4, 2, NumpyBackend())
        for row, chunk in zip(oracle.encode_batch(np.stack(rows)[None])[0],
                              part.parity):
            assert AnyHash.from_buf(bytes(row)) == chunk.hash
        os.remove(part.data[0].locations[0].target)
        os.remove(part.data[1].locations[0].target)
        reader = await cluster.read_file("f")
        assert await read_all(reader) == payload
        report = await ref.resilver(cluster.get_destination(profile),
                                    backend=cluster.tunables.backend)
        assert report.integrity() == FileIntegrity.RESILVERED
        assert (await ref.verify()).integrity() == FileIntegrity.VALID

    run(main())


async def read_all(reader) -> bytes:
    out = []
    while (blk := await reader.read(1 << 20)):
        out.append(bytes(blk))
    return b"".join(out)


def test_wide_stripe_mesh_cluster_lifecycle(tmp_path, cpu_meshes):
    """The ('dp','tp') mesh from the YAML's ``jax:tp4``: parity equal to
    the oracle, a degraded read through the tp decode, resilver, verify."""
    cluster = Cluster.from_obj(cluster_obj(
        tmp_path, [], d=8, p=2, tunables={"backend": "jax:tp4"}))
    cluster.destinations = ClusterNodes.from_obj(
        [{"location": x, "repeat": 2} for x in disks(tmp_path, 4)])
    payload = synthetic(150000, 9)

    async def main():
        await cluster.write_file("w", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("w")
        part = ref.parts[0]
        rows = [np.frombuffer(pathlib.Path(c.locations[0].target)
                              .read_bytes(), dtype=np.uint8)
                for c in part.data]
        want = ErasureCoder(8, 2, NumpyBackend()).encode_batch(
            np.stack(rows)[None])[0]
        for w, c in zip(want, part.parity):
            assert pathlib.Path(c.locations[0].target).read_bytes() \
                == w.tobytes()
        for part in ref.parts:
            os.remove(part.data[0].locations[0].target)
            os.remove(part.parity[0].locations[0].target)
        assert await read_all(await cluster.read_file("w")) == payload
        rep = await ref.resilver(
            cluster.get_destination(cluster.get_profile()),
            backend=cluster.tunables.backend)
        assert rep.new_locations()
        assert (await ref.verify()).integrity() == FileIntegrity.VALID

    run(main())


@pytest.mark.parametrize("name", ["jax:dp4,sp2", "jax:tp4"])
def test_mesh_resilver_coalesces_parts_per_dispatch(tmp_path, monkeypatch,
                                                    cpu_meshes, name):
    """8 parts with one loss pattern: the read shares one batcher, and
    resilver rebuilds them in fewer dispatches than parts."""
    d, p = 8, 2
    cluster = Cluster.from_obj(cluster_obj(
        tmp_path, [], d=d, p=p, tunables={"backend": name}))
    cluster.destinations = ClusterNodes.from_obj(
        [{"location": x, "repeat": 2} for x in disks(tmp_path, 4)])
    payload = synthetic(8 * d * (1 << 12), 21)
    captured = []

    class Capturing(batching.ReconstructBatcher):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(batching, "ReconstructBatcher", Capturing)

    async def main():
        await cluster.write_file("m", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("m")
        assert len(ref.parts) == 8
        for part in ref.parts:
            os.remove(part.data[0].locations[0].target)
            os.remove(part.parity[0].locations[0].target)
        assert await read_all(await cluster.read_file("m")) == payload
        assert len(captured) == 1
        rep = await ref.resilver(
            cluster.get_destination(cluster.get_profile()), backend=name)
        assert rep.integrity() == FileIntegrity.RESILVERED
        assert 1 <= captured[-1].dispatches < 8
        assert (await ref.verify()).integrity() == FileIntegrity.VALID

    run(main())


# ---- backend names in a shared YAML ----

@pytest.mark.parametrize("name,canonical", [
    ("jax", "cuda"), ("jax:dp2,tp4", "cuda:dp2,tp4"), ("jax:tp4", "cuda:tp4"),
    ("auto", "cuda"), (None, "cuda"), ("cuda", "cuda"),
    ("cuda:dp4,sp2", "cuda:dp4,sp2"), ("mesh", "mesh")])
def test_backend_aliases_resolve_to_the_card(monkeypatch, name, canonical):
    """The JAX package's names resolve to the card; without one they
    raise, and none of them falls back to a CPU backend."""
    import torch

    monkeypatch.delenv("CHUNKY_BITS_TORCH_BACKEND")
    assert backend.canonical_backend_name(name) == canonical
    assert Tunables(backend=name).is_device_backend()
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(ErasureError, match="CUDA"):
        backend.get_backend(name)
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    if name in (None, "auto"):
        assert backend.get_backend(name).name == "torch"
        assert not Tunables(backend=name).is_device_backend()


@pytest.mark.parametrize("name", ["native", "native:4"])
def test_native_backend_is_refused_by_name(name):
    """``native`` and ``native:N`` build the port's host codec, a host
    backend; a thread count that is not a positive integer is refused by
    name, as in the JAX package."""
    from chunky_bits_tpu_torch.ops.cpu_backend import NativeBackend

    be = backend.get_backend(name)
    assert isinstance(be, NativeBackend) and be.name == name
    assert be.nthreads == (4 if name == "native:4" else 0)
    assert Tunables(backend=name).is_device_backend() is False
    for bad in ("native:0", "native:x", "native:"):
        with pytest.raises(ErasureError, match="bad native thread count"):
            backend.get_backend(bad)
        with pytest.raises(ErasureError, match="bad native thread count"):
            Tunables(backend=bad).is_device_backend()


def test_tpu_example_backend_round_trips(tmp_path):
    """examples/tpu.yaml (its slab destinations left out) keeps
    ``backend: jax`` as written, and names a device backend."""
    obj = yaml.safe_load((EXAMPLES / "tpu.yaml").read_text())
    obj["destinations"] = [d for d in obj["destinations"]
                           if not d["location"].startswith("slab:")]
    cluster = Cluster.from_obj(obj)
    assert cluster.tunables.backend == "jax"
    assert cluster.tunables.is_device_backend()
    assert cluster.to_obj()["tunables"]["backend"] == "jax"


# ---- tunables ----

@pytest.mark.parametrize("obj,error", [
    # the SLO engine and QoS are ported: these three cases keep their ids
    # and now check that an invalid mapping or a negative cadence refuses
    # (test_tunables_round_trip_equals_jax loads valid ones)
    pytest.param({"slo": {"fast_s": -60}},
                 "invalid slo mapping: slo objective fast_s must be >= 0",
                 id="obj0-tunables.slo: .*not yet ported .*item 5"),
    pytest.param({"qos": {"enabled": "yes"}},
                 "invalid qos mapping: enabled must be a bool",
                 id="obj1-tunables.qos: .*not yet ported .*item 5"),
    # request tracing and the chunk cache are ported: these two cases keep
    # their ids and now check that a negative or malformed value refuses
    pytest.param({"trace_slow_ms": -250}, "trace_slow_ms must be >= 0",
                 id="obj2-request tracing is not yet ported .*item 5"),
    pytest.param({"slo_eval_s": -15}, "slo_eval_s must be >= 0",
                 id="obj3-tunables.slo_eval_s: .*not yet ported .*item 5"),
    # the scrub daemon is ported: the case keeps its id and now checks
    # that a negative rate refuses
    pytest.param({"scrub_bytes_per_sec": -1},
                 "scrub_bytes_per_sec must be >= 0",
                 id="obj4-scrub daemon is not yet ported .*6"),
    pytest.param({"cache_bytes": "lots"}, "invalid cache_bytes",
                 id="obj5-chunk cache is not yet ported .*item 5"),
    ({"on_conflict": "clobber"}, "invalid on_conflict"),
    ({"host_threads": -1}, "host_threads must be >= 0"),
    ({"repair_block_bytes": "big"}, "invalid repair_block_bytes"),
])
def test_tunables_refuse_loudly(obj, error):
    with pytest.raises(SerdeError, match=error):
        Tunables.from_obj(obj)


def test_tunables_round_trip_equals_jax(monkeypatch):
    from chunky_bits_tpu.cluster.tunables import Tunables as JaxTunables

    for knob in ("HEDGE_MS", "READ_RETRIES", "CACHE_BYTES", "HOST_THREADS",
                 "REPAIR_BLOCK_BYTES", "SCRUB_BYTES_PER_SEC",
                 "TRACE_SLOW_MS", "SLO_EVAL_S"):
        monkeypatch.delenv("CHUNKY_BITS_TPU_" + knob, raising=False)
    obj = {"backend": "jax:tp4", "host_threads": 3, "hedge_ms": 25,
           "read_retries": 0, "repair_block_bytes": 4096,
           "scrub_bytes_per_sec": 0, "on_conflict": "overwrite",
           "slo_eval_s": 15, "slo": {"fast_s": 60, "min_workers": 2},
           "qos": {"enabled": True, "tenants": {"gold": {
               "weight": 4, "keys": ["k"], "prefixes": ["/g/"]}},
               "other": {"weight": 2}}}
    ours = Tunables.from_obj(obj).to_obj()
    assert ours == JaxTunables.from_obj(obj).to_obj()
    assert Tunables.from_obj(ours).to_obj() == ours
    assert Tunables.from_obj({}).to_obj() == JaxTunables.from_obj({}) \
        .to_obj()


def test_cache_bytes_env_is_refused(monkeypatch):
    """The chunk cache is ported: ``$CHUNKY_BITS_TORCH_CACHE_BYTES`` now
    supplies the default, and a malformed or negative value is refused
    (read as off); the JAX package's variable never reaches the port."""
    monkeypatch.setenv("CHUNKY_BITS_TORCH_CACHE_BYTES", "4096")
    assert Tunables.from_obj({}).cache_bytes == 4096
    for bad in ("-1", "lots"):
        monkeypatch.setenv("CHUNKY_BITS_TORCH_CACHE_BYTES", bad)
        assert Tunables.from_obj({}).cache_bytes == 0
    monkeypatch.delenv("CHUNKY_BITS_TORCH_CACHE_BYTES")
    monkeypatch.setenv("CHUNKY_BITS_TPU_CACHE_BYTES", "4096")
    assert Tunables.from_obj({}).cache_bytes == 0


# ---- goldens and pm-msr against the JAX package ----

def test_cluster_writes_the_placement_golden(tmp_path, monkeypatch):
    """tests/golden/generate.py's fixture 3 through the port's Cluster:
    relative-path destinations, hash-seeded weighted placement."""
    monkeypatch.chdir(tmp_path)
    for i in range(5):
        os.mkdir(f"d{i}")
    os.mkdir("meta")
    cluster = Cluster.from_obj(gen.cluster_spec("meta"))
    ref = run(cluster.get_file_writer(cluster.get_profile())
              .write(aio.BytesReader(gen.payload(30_000, 3))))
    assert gen.dump(ref.to_obj()) == golden("cluster_placement")


def test_writer_writes_the_pm_msr_golden():
    ref = run(FileWriteBuilder().with_backend("torch")
              .with_chunk_size(1 << 14).with_data_chunks(3)
              .with_parity_chunks(2).with_code("pm-msr")
              .write(aio.BytesReader(gen.payload(100_000, 1))))
    assert gen.dump(ref.to_obj()) == golden("pm_msr_placement")


@pytest.mark.parametrize("d,p,s", [(3, 2, 64), (5, 4, 4096), (4, 3, 99)])
def test_pm_msr_equals_jax(d, p, s):
    """Encode, a degraded read and a single-chunk regeneration through the
    port (torch) and the JAX package (numpy): tolerance 0."""
    ours = backend.get_coder(d, p, "torch", "pm-msr")
    theirs = jax_get_coder(d, p, "numpy", "pm-msr")
    alpha = d - 1
    size = s * alpha
    data = np.random.default_rng(d * 100 + p).integers(
        0, 256, (2, d, size), dtype=np.uint8)
    parity, digests = ours.encode_hash_batch(data)
    want_parity, want_digests = theirs.encode_hash_batch(data)
    assert np.array_equal(parity, want_parity)
    assert np.array_equal(digests, want_digests)
    full = np.concatenate([data, parity], axis=1)
    lost = list(range(0, d + p, 2))[:p]
    shards = [None if i in lost else full[0, i] for i in range(d + p)]
    assert all(np.array_equal(a, b) for a, b in zip(
        ours.reconstruct_data(shards)[:d],
        theirs.reconstruct_data(shards)[:d]))
    failed = d  # a parity chunk
    helpers = [i for i in range(d + p) if i != failed][:ours.helpers]
    proj = np.stack([ours.project_batch(failed, full[:, h])
                     for h in helpers], axis=1)
    assert np.array_equal(
        proj, np.stack([theirs.project_batch(failed, full[:, h])
                        for h in helpers], axis=1))
    rebuilt = ours.repair_batch(failed, helpers, proj)
    assert np.array_equal(rebuilt, theirs.repair_batch(failed, helpers, proj))
    assert np.array_equal(rebuilt, full[:, failed])


def test_pm_msr_cluster_round_trip(tmp_path):
    """A ``code: pm-msr`` profile: ingest, one lost chunk per part,
    degraded read, resilver; the JAX package reads the same tree."""
    from chunky_bits_tpu.file import FileReference as JaxReference

    cluster = Cluster.from_obj(cluster_obj(tmp_path, disks(tmp_path, 9),
                                           d=5, p=4))
    cluster.get_profile().code = "pm-msr"
    payload = synthetic(5 * 4096 * 3 + 777, 13)

    async def main():
        await cluster.write_file("pm", aio.BytesReader(payload),
                                 cluster.get_profile())
        ref = await cluster.get_file_ref("pm")
        assert {part.code for part in ref.parts} == {"pm-msr"}
        for i, part in enumerate(ref.parts):
            chunk = (part.data + part.parity)[i % 9]
            os.remove(chunk.locations[0].target)
        assert await read_all(await cluster.read_file("pm")) == payload
        rep = await ref.resilver(cluster.get_destination(
            cluster.get_profile()))
        assert len(rep.new_locations()) == len(ref.parts)
        assert await (JaxReference.from_obj(ref.to_obj()).read_builder()
                      .with_backend("numpy").read_all()) == payload

    run(main())


def test_get_coder_builds_pm_msr_and_checks_geometry():
    coder = backend.get_coder(5, 4, "torch", "pm-msr")
    assert coder.code == "pm-msr" and not coder.supports_fused_ingest
    assert backend.get_coder(5, 4, "torch", "pm-msr") is coder
    with pytest.raises(ErasureError, match="parity >= data-1"):
        backend.get_coder(10, 4, "torch", "pm-msr")


def test_cluster_random_geometries_equal_jax(tmp_path):
    """Random small geometries: the port's cluster and the JAX package's
    write the same reference from the same YAML (placement included)."""
    from chunky_bits_tpu.cluster import Cluster as JaxCluster
    from chunky_bits_tpu.utils import aio as jaio

    rng = random.Random(5)
    for trial in range(4):
        d, p = rng.randint(1, 6), rng.randint(0, 3)
        payload = synthetic(rng.randint(0, 40000), trial)
        refs = []
        for side, cls, reader in (("port", Cluster, aio.BytesReader),
                                  ("jax", JaxCluster, jaio.BytesReader)):
            root = tmp_path / f"{trial}" / side
            obj = cluster_obj(root, disks(root, d + p + 2), d=d, p=p,
                              chunk_size=10)
            obj["tunables"] = {"backend": "torch" if side == "port"
                               else "numpy"}
            cluster = cls.from_obj(obj)
            ref = run(cluster.get_file_writer(cluster.get_profile())
                      .write(reader(payload)))
            refs.append(yaml.safe_dump(ref.to_obj()).replace(
                str(root), "<root>"))
        assert refs[0] == refs[1], (trial, d, p)
