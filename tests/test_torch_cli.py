"""The port's CLI (``chunky_bits_tpu_torch.cli.main``), held against the
assertions of ``tests/test_cli.py``, and against the JAX package's CLI.

Most tests call ``main(argv)`` in this process with standard input and
output swapped for buffers (a subprocess pays its own start); two
run the ``python -m`` entry points.  A cluster written by either
package's CLI must read back, verify and resilver identically through the
other's.  Every call names a config file of its own, so nothing reads
``/etc/chunky-bits.yaml``.
"""

import asyncio
import hashlib
import io
import json
import os
import random
import shutil
import subprocess
import sys
import time

import pytest
import yaml

from chunky_bits_tpu.cli.main import main as jax_main
from chunky_bits_tpu_torch.cli.cluster_location import ClusterLocation
from chunky_bits_tpu_torch.cli.main import build_parser
from chunky_bits_tpu_torch.cli.main import main as port_main
from chunky_bits_tpu_torch.utils import aio
from tests.test_torch_file import bounded, run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def torch_default(monkeypatch, tmp_path):
    monkeypatch.setenv("CHUNKY_BITS_TORCH_BACKEND", "torch")
    for knob in ("CODE", "METADATA_KIND", "CACHE_BYTES"):
        monkeypatch.delenv("CHUNKY_BITS_TORCH_" + knob, raising=False)
    (tmp_path / "config.yaml").write_text("")


def call(main, tmp_path, *argv, stdin=b"", rc=0):
    """``main(["--config", <empty>, *argv])`` with stdin, stdout and
    stderr swapped for buffers; returns (stdout bytes, stderr text)."""
    saved = sys.stdin, sys.stdout, sys.stderr
    out = io.TextIOWrapper(io.BytesIO(), write_through=True)
    err = io.StringIO()
    sys.stdin = io.TextIOWrapper(io.BytesIO(stdin))
    sys.stdout, sys.stderr = out, err
    try:
        got = bounded(lambda: main(
            ["--config", str(tmp_path / "config.yaml"), *argv]))
        out.flush()
    finally:
        sys.stdin, sys.stdout, sys.stderr = saved
    assert got == rc, (argv, got, err.getvalue())
    return out.buffer.getvalue(), err.getvalue()


def cli(tmp_path, *argv, **kwargs):
    return call(port_main, tmp_path, *argv, **kwargs)


def make_cluster_yaml(root, name="cluster.yaml", n=5, d=3, p=2,
                      chunk_size=16, backend=None):
    dirs = []
    for i in range(n):
        dd = root / f"{name}.disk{i}"
        dd.mkdir(parents=True)
        dirs.append(str(dd))
    meta = root / f"{name}.meta"
    meta.mkdir()
    spec = {
        "destinations": [{"location": x} for x in dirs],
        "metadata": {"type": "path", "format": "yaml", "path": str(meta)},
        "profiles": {"default": {"data": d, "parity": p,
                                 "chunk_size": chunk_size}},
    }
    if backend is not None:
        spec["tunables"] = {"backend": backend}
    path = root / name
    path.write_text(yaml.safe_dump(spec))
    return path


@pytest.fixture
def cluster_yaml(tmp_path):
    return make_cluster_yaml(tmp_path)


def ref_obj(tmp_path, conf, name):
    return yaml.safe_load(cli(tmp_path, "file-info", f"{conf}#{name}")[0])


def payload(n, seed=0):
    import numpy as np

    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("text,kind,cluster,profile", [
    ("mycluster#path/to/file", "cluster", "mycluster", None),
    ("mycluster[fast]#path", "cluster", "mycluster", "fast"),
    ("./cluster.yaml#file", "cluster", "./cluster.yaml", None),
    ("@#/tmp/ref.yaml", "file_ref", None, None),
    ("/tmp/file", "other", None, None),
    ("-", "stdio", None, None),
])
def test_cluster_location_grammar(text, kind, cluster, profile):
    loc = ClusterLocation.parse(text)
    assert (loc.kind, loc.cluster, loc.profile) == (kind, cluster, profile)
    assert str(loc) == text


def test_cp_cat_roundtrip(cluster_yaml, tmp_path):
    data = payload(256 * 1024 * 3 + 77, 1)
    src = tmp_path / "input.bin"
    src.write_bytes(data)
    cli(tmp_path, "cp", str(src), f"{cluster_yaml}#files/input.bin")
    out, _ = cli(tmp_path, "cat", f"{cluster_yaml}#files/input.bin")
    assert hashlib.sha256(out).digest() == hashlib.sha256(data).digest()
    meta = ref_obj(tmp_path, cluster_yaml, "files/input.bin")
    assert meta["length"] == len(data)
    ref_file = tmp_path / "input.ref"
    ref_file.write_text(yaml.safe_dump(meta))
    assert cli(tmp_path, "cat", f"@#{ref_file}")[0] == data
    # cp to a plain path streams through Location.write_from_reader
    cli(tmp_path, "cp", f"{cluster_yaml}#files/input.bin",
        str(tmp_path / "copy.bin"))
    assert (tmp_path / "copy.bin").read_bytes() == data


def test_cp_from_stdin_and_ls(cluster_yaml, tmp_path):
    data = b"stdin payload" * 1000
    cli(tmp_path, "cp", "-", f"{cluster_yaml}#a/b/from-stdin", stdin=data)
    cli(tmp_path, "cp", "-", f"{cluster_yaml}#file2", stdin=b"y")
    assert cli(tmp_path, "cat", f"{cluster_yaml}#a/b/from-stdin")[0] == data
    listing = cli(tmp_path, "ls", f"{cluster_yaml}#.")[0].decode() \
        .splitlines()
    assert "file2" in listing and "a" in listing
    listing = cli(tmp_path, "ls", "-r", f"{cluster_yaml}#.")[0].decode() \
        .splitlines()
    assert "a/b/from-stdin" in listing and "file2" in listing


def test_verify_and_resilver_cli(cluster_yaml, tmp_path):
    cli(tmp_path, "cp", "-", f"{cluster_yaml}#victim",
        stdin=payload(200000, 2))
    meta = ref_obj(tmp_path, cluster_yaml, "victim")
    victim = meta["parts"][0]["data"][0]["locations"][0]
    os.remove(victim)
    assert "Degraded" in cli(tmp_path, "verify",
                             f"{cluster_yaml}#victim")[0].decode()
    out = cli(tmp_path, "resilver", f"{cluster_yaml}#victim")[0].decode()
    assert "Resilvered" in out or "Valid" in out
    assert f"location\tUnavailable\t{victim}" in out
    rebuilt = ref_obj(tmp_path, cluster_yaml, "victim")["parts"][0]["data"][0]
    assert any(os.path.exists(loc) for loc in rebuilt["locations"])
    assert cli(tmp_path, "verify", f"{cluster_yaml}#victim")[0] \
        .startswith(b"file\tValid")


def test_encode_decode_shards(tmp_path):
    data = payload(10000, 3)
    src = tmp_path / "src.bin"
    src.write_bytes(data)
    shards = [str(tmp_path / f"shard{i}") for i in range(5)]
    geometry = ("--data-chunks", "3", "--parity-chunks", "2")
    cli(tmp_path, *geometry, "encode-shards", str(src), *shards)
    os.remove(shards[0])
    os.remove(shards[4])
    out, err = cli(tmp_path, *geometry, "decode-shards", *shards)
    assert out[:len(data)] == data and len(out) >= len(data)
    assert "Error" in err  # the two missing shards are named


def test_file_info_and_get_hashes(cluster_yaml, tmp_path):
    data = payload(70000, 4)
    cli(tmp_path, "cp", "-", f"{cluster_yaml}#hashed", stdin=data)
    info = yaml.safe_load(cli(tmp_path, "file-info",
                              f"{cluster_yaml}#hashed")[0])
    assert info == json.loads(cli(tmp_path, "file-info", "--json",
                                  f"{cluster_yaml}#hashed")[0])
    assert info["length"] == len(data)
    hashes = cli(tmp_path, "get-hashes",
                 f"{cluster_yaml}#hashed")[0].decode().split()
    assert hashes == ["sha256-" + c["sha256"] for part in info["parts"]
                      for c in part["data"] + part.get("parity", [])]
    assert cli(tmp_path, "get-hashes", "--sort",
               f"{cluster_yaml}#hashed")[0].decode().split() \
        == sorted(set(hashes))


def test_migrate(cluster_yaml, tmp_path):
    """migrate references a file in place through range-sliced locations;
    the ref is Degraded until resilver writes its parity."""
    data = payload(150000, 5)
    src = tmp_path / "existing.bin"
    src.write_bytes(data)
    cli(tmp_path, "migrate", str(src), f"{cluster_yaml}#migrated")
    assert cli(tmp_path, "cat", f"{cluster_yaml}#migrated")[0] == data
    first = ref_obj(tmp_path, cluster_yaml,
                    "migrated")["parts"][0]["data"][0]["locations"][-1]
    assert str(src) in first and first.startswith("(")
    verify = cli(tmp_path, "verify", f"{cluster_yaml}#migrated")[0]
    assert verify.splitlines()[0].strip().endswith(b"Degraded")
    cli(tmp_path, "resilver", f"{cluster_yaml}#migrated")
    verify = cli(tmp_path, "verify", f"{cluster_yaml}#migrated")[0]
    assert verify.splitlines()[0].strip().endswith(b"Valid")
    assert cli(tmp_path, "cat", f"{cluster_yaml}#migrated")[0] == data


def test_find_unused_hashes(cluster_yaml, tmp_path):
    data = payload(100000, 6)
    cli(tmp_path, "cp", "-", f"{cluster_yaml}#live", stdin=data)
    orphan = "sha256-" + hashlib.sha256(b"orphan").hexdigest()
    orphan_path = tmp_path / "cluster.yaml.disk0" / orphan
    orphan_path.write_bytes(b"orphan")
    disks = [str(tmp_path / f"cluster.yaml.disk{i}") for i in range(5)]
    # a fresh file is inside the grace window: an in-flight write's chunk
    fresh = cli(tmp_path, "find-unused-hashes", f"{cluster_yaml}#.", "--",
                *disks)[0].decode().split()
    assert fresh == []
    old = os.stat(orphan_path).st_mtime - 3600
    os.utime(orphan_path, (old, old))
    out = cli(tmp_path, "find-unused-hashes", f"{cluster_yaml}#.", "--",
              *disks)[0].decode().split()
    assert out == [orphan]
    cli(tmp_path, "find-unused-hashes", "--remove", f"{cluster_yaml}#.",
        "--", *disks)
    assert not orphan_path.exists()
    assert cli(tmp_path, "cat", f"{cluster_yaml}#live")[0] == data


def test_cluster_info_and_config_info(tmp_path):
    conf = make_cluster_yaml(tmp_path, backend="jax:dp2,tp4")
    obj = yaml.safe_load(cli(tmp_path, "cluster-info", str(conf))[0])
    assert len(obj["destinations"]) == 5
    # the backend round-trips as written
    assert obj["tunables"]["backend"] == "jax:dp2,tp4"
    obj = json.loads(cli(tmp_path, "cluster-info", "--json", str(conf))[0])
    assert obj["profiles"]["default"]["data_chunks"] == 3
    obj = yaml.safe_load(cli(tmp_path, "config-info")[0])
    assert obj["default_destination"]["type"] == "void"


@pytest.mark.parametrize("argv,message", [
    (("cat", "{conf}#does-not-exist"), "No such file"),
    (("cat", "nonexistent-cluster#x"), "not defined"),
    (("resilver", "/tmp/just-a-file"), "only supported on cluster"),
    # slab destinations are ported: the case keeps its id and now checks
    # that a slab address naming a store root, not a chunk, is refused
    pytest.param(("cp", "-", "slab:x"), "names a store root, not a chunk",
                 id="argv3-slab locations are not yet ported"),
    # http and sim destinations are ported (a cp to http would dial the
    # host): the case keeps its id and now checks that a sim: address
    # outside a simulator run, with no live fabric, is refused
    pytest.param(("cp", "-", "sim:fabric/n0/x"),
                 "no live sim fabric 'fabric'",
                 id="argv4-http locations are not yet ported"),
])
def test_error_paths(cluster_yaml, tmp_path, argv, message):
    argv = [a.format(conf=cluster_yaml) for a in argv]
    _out, err = cli(tmp_path, *argv, rc=1)
    assert message in err


@pytest.mark.parametrize("command",
                         ["http-gateway", "meta-compact", "scrub", "stats"])
def test_ported_commands_parse_and_run(cluster_yaml, tmp_path, command):
    """Every one of these commands is ported now, and parses the JAX
    package's arguments with its defaults.  ``stats`` on an unreachable
    gateway and ``meta-compact`` on a path metadata store fail loudly;
    ``scrub --once`` on a healthy cluster scans it and repairs
    nothing."""
    from chunky_bits_tpu.cli.main import build_parser as jax_parser

    argv = {"http-gateway": [command, str(cluster_yaml)],
            "meta-compact": [command, str(cluster_yaml),
                             "--from-path-store", "d"],
            "scrub": [command, str(cluster_yaml), "--once",
                      "--bytes-per-sec", "5", "--interval", "2",
                      "--no-repair"],
            "stats": [command, "--json", "127.0.0.1:1"]}[command]
    ours = vars(build_parser().parse_args(argv))
    theirs = vars(jax_parser().parse_args(argv))
    ours.pop("backend", None)
    theirs.pop("backend", None)
    assert ours == theirs
    if command == "stats":
        # an unreachable gateway fails loudly, not with "not yet ported"
        _out, err = cli(tmp_path, *argv, rc=1)
        assert "cannot reach gateway" in err
    elif command == "meta-compact":
        _out, err = cli(tmp_path, command, str(cluster_yaml), rc=1)
        assert "is not a meta-log store" in err
    elif command == "scrub":
        cli(tmp_path, "cp", "-", f"{cluster_yaml}#f", stdin=b"x" * 5000)
        out, _err = cli(tmp_path, command, str(cluster_yaml), "--once")
        assert out.startswith(b"Scrub<scanned=1f/") and b"corrupt=0" in out


@pytest.mark.parametrize("tunable,item", [
    ({"slo": {"fast_s": 60}}, "5b"), ({"qos": {"enabled": True}}, "5b"),
    ({"slo_eval_s": 15}, "5b"),
    # the scrub daemon is ported: the case keeps its id and now checks
    # that such a cluster loads and keeps the tunable
    pytest.param({"scrub_bytes_per_sec": 1e6}, None, id="tunable3-6")])
def test_serving_tunables_load_and_invalid_values_refuse(tmp_path, tunable,
                                                       item):
    """The serving plane's opt-in tunables are ported (item 5b: the SLO
    engine and QoS; item 6: the scrub daemon): a cluster YAML naming them
    loads for every command and keeps each value as written, and for the
    5b cases an invalid value fails every command that loads the YAML,
    the gateway's too, naming the tunable."""
    conf = make_cluster_yaml(tmp_path)
    spec = yaml.safe_load(conf.read_text())
    spec["tunables"] = tunable
    conf.write_text(yaml.safe_dump(spec))
    key = next(iter(tunable))
    cli(tmp_path, "ls", f"{conf}#.")
    out, _err = cli(tmp_path, "cluster-info", "--json", str(conf))
    assert json.loads(out)["tunables"][key] == tunable[key]
    if item is None:
        return
    bad = {"slo": {"fast_s": "soon"}, "qos": {"enabled": 1},
           "slo_eval_s": -1}[key]
    spec["tunables"] = {key: bad}
    conf.write_text(yaml.safe_dump(spec))
    for argv in (("ls", f"{conf}#."),
                 ("http-gateway", str(conf), "-l", "127.0.0.1:0")):
        _out, err = cli(tmp_path, *argv, rc=1)
        assert key in err and ("invalid" in err or ">= 0" in err), err


def test_backend_help_names_the_ports_backends():
    text = build_parser().format_help()
    for name in ("cuda", "cuda:<spec>", "mesh", "native", "native:<N>",
                 "torch", "numpy"):
        assert name in text


@pytest.mark.parametrize("backend,error", [
    ("native", "not yet ported (ROADMAP Queue A item 4)"),
    ("cuda", "CUDA is not available"),
    ("jax", "CUDA is not available"),
])
def test_device_and_native_names_refuse_on_the_cpu(tmp_path, backend,
                                                   error):
    import torch

    conf = make_cluster_yaml(tmp_path, backend=backend)
    if backend == "native":
        # the host codec is ported: the refusal is gone, and the object
        # writes and reads back on the CPU
        _out, err = cli(tmp_path, "cp", "-", f"{conf}#x", stdin=b"data")
        assert error not in err
        out, _err = cli(tmp_path, "cat", f"{conf}#x")
        assert out == b"data"
        return
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _out, err = cli(tmp_path, "cp", "-", f"{conf}#x", stdin=b"data", rc=1)
    assert error in err
    assert not any(os.listdir(tmp_path / f"cluster.yaml.disk{i}")
                   for i in range(5)), "nothing may be written"


def test_broken_pipe_exits_quietly(cluster_yaml, tmp_path, monkeypatch):
    """``cat | head``: a closed stdout ends the command with 141 and no
    traceback, as the reference binary."""
    cli(tmp_path, "cp", "-", f"{cluster_yaml}#pipe", stdin=payload(1 << 16))

    class Closed(io.RawIOBase):
        def writable(self):
            return True

        def write(self, b):
            raise BrokenPipeError()

    saved = sys.stdout
    sys.stdout = io.TextIOWrapper(io.BufferedWriter(Closed()))
    try:
        got = bounded(lambda: port_main(
            ["--config", str(tmp_path / "config.yaml"), "cat",
             f"{cluster_yaml}#pipe"]))
    finally:
        sys.stdout = saved
    assert got == 141


def test_cp_cluster_to_cluster(cluster_yaml, tmp_path):
    second = make_cluster_yaml(tmp_path, "cluster2.yaml", d=4, p=1,
                               chunk_size=14)
    data = payload(200000, 7)
    cli(tmp_path, "cp", "-", f"{cluster_yaml}#src-obj", stdin=data)
    cli(tmp_path, "cp", f"{cluster_yaml}#src-obj", f"{second}#dst-obj")
    assert cli(tmp_path, "cat", f"{second}#dst-obj")[0] == data
    meta = ref_obj(tmp_path, second, "dst-obj")
    assert len(meta["parts"][0]["data"]) == 4
    assert len(meta["parts"][0]["parity"]) == 1


def test_python_decoder_interop(cluster_yaml, tmp_path):
    """The reference's read-only decoder (python/chunky-bits.py)
    reassembles a file the port wrote."""
    data = payload(300000, 8)
    cli(tmp_path, "cp", "-", f"{cluster_yaml}#files/interop", stdin=data)
    ref_path = tmp_path / "interop.ref"
    ref_path.write_text(yaml.safe_dump(ref_obj(tmp_path, cluster_yaml,
                                               "files/interop")))
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "python", "chunky-bits.py"),
         str(ref_path)], capture_output=True, timeout=60)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == data


# ---- across the packages ----

def relative(text: bytes, root) -> str:
    return text.decode().replace(str(root), "<root>")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cluster_cli_across_packages(tmp_path, monkeypatch, writer):
    """One package's CLI writes a cluster; the other's reads it back
    byte-identically, and on two copies of the same damaged tree both
    CLIs report the same verify and resilver, which each package then
    reads back.  The JAX package runs on numpy (its ``--backend``), the
    port on torch (its own environment variable)."""
    monkeypatch.setenv("CHUNKY_BITS_TPU_BACKEND", "numpy")
    clis = {"jax": lambda *a, **k: call(jax_main, tmp_path, "--backend",
                                        "numpy", *a, **k),
            "port": lambda *a, **k: cli(tmp_path, *a, **k)}
    other = "port" if writer == "jax" else "jax"
    trees = [tmp_path / "a", tmp_path / "b"]
    conf = make_cluster_yaml(trees[0], d=3, p=2, chunk_size=12)
    data = payload(5 * 3 * 4096 + 1234, 9)
    # from standard input: the JAX package's ``cp`` leaves a file source
    # for the collector to close
    clis[writer]("cp", "-", f"{conf}#obj", stdin=data)
    assert clis[other]("cat", f"{conf}#obj")[0] == data
    info = {side: yaml.safe_load(clis[side]("file-info", f"{conf}#obj")[0])
            for side in clis}
    assert info["jax"] == info["port"]
    for part in info[writer]["parts"]:
        os.remove(part["data"][0]["locations"][0])
    shutil.copytree(trees[0], trees[1])
    conf_b = trees[1] / "cluster.yaml"
    conf_b.write_text(conf.read_text().replace(str(trees[0]),
                                               str(trees[1])))
    (trees[1] / "cluster.yaml.meta" / "obj").write_text(
        (trees[0] / "cluster.yaml.meta" / "obj").read_text().replace(
            str(trees[0]), str(trees[1])))
    for cmd in ("verify", "resilver", "verify"):
        ours = clis[other](cmd, f"{conf}#obj")[0]
        theirs = clis[writer](cmd, f"{conf_b}#obj")[0]
        assert relative(ours, trees[0]) == relative(theirs, trees[1]), cmd
    assert ours.startswith(b"file\tValid")
    for side, root in ((writer, conf), (other, conf_b)):
        assert clis[side]("cat", f"{root}#obj")[0] == data


@pytest.mark.parametrize("spelling", ["native", "native:2"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_native_yaml_across_packages(tmp_path, monkeypatch, writer,
                                     spelling):
    """A cluster YAML naming ``backend: native`` (or ``native:N``) loads in
    both packages: one package's CLI writes through its native codec, the
    other's reads the object back, both verify it Valid, and the file
    reference equals the one a ``numpy`` cluster writes."""
    monkeypatch.delenv("CHUNKY_BITS_TPU_BACKEND", raising=False)
    clis = {"jax": lambda *a, **k: call(jax_main, tmp_path, *a, **k),
            "port": lambda *a, **k: cli(tmp_path, *a, **k)}
    other = "port" if writer == "jax" else "jax"
    conf = make_cluster_yaml(tmp_path / "n", d=3, p=2, chunk_size=12,
                             backend=spelling)
    plain = make_cluster_yaml(tmp_path / "p", d=3, p=2, chunk_size=12,
                              backend="numpy")
    data = payload(4 * 3 * 4096 + 555, 12)
    clis[writer]("cp", "-", f"{conf}#obj", stdin=data)
    clis[writer]("cp", "-", f"{plain}#obj", stdin=data)
    assert clis[other]("cat", f"{conf}#obj")[0] == data
    for side in clis:
        assert clis[side]("verify", f"{conf}#obj")[0].startswith(
            b"file\tValid")

    def hashes(root):
        ref = yaml.safe_load(clis[other]("file-info", f"{root}#obj")[0])
        return [[c["sha256"] for c in part["data"] + part["parity"]]
                for part in ref["parts"]]

    assert hashes(conf) == hashes(plain)


# ---- the python -m entry points ----

def test_python_m_cat_of_a_cluster_object(cluster_yaml, tmp_path):
    data = payload(3 * 65536 + 77, 10)
    cli(tmp_path, "cp", "-", f"{cluster_yaml}#obj", stdin=data)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "chunky_bits_tpu_torch", "--config",
         str(tmp_path / "config.yaml"), "cat", f"{cluster_yaml}#obj"],
        capture_output=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout == data


def test_python_m_cli_cp_on_the_default_backend_refuses_without_a_card(
        tmp_path):
    """No backend named and none in the environment: the default is the
    card, so without one ``cp`` exits non-zero with the ErasureError and
    writes nothing through the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    conf = make_cluster_yaml(tmp_path)
    src = tmp_path / "src.bin"
    src.write_bytes(b"x" * 1000)
    env = {k: v for k, v in os.environ.items()
           if k != "CHUNKY_BITS_TORCH_BACKEND"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-m", "chunky_bits_tpu_torch.cli", "--config",
         str(tmp_path / "config.yaml"), "cp", str(src), f"{conf}#obj"],
        capture_output=True, env=env, cwd=REPO, timeout=120)
    assert proc.returncode != 0
    assert b"CUDA is not available" in proc.stderr
    assert not any(os.listdir(tmp_path / f"cluster.yaml.disk{i}")
                   for i in range(5))
    assert not os.listdir(tmp_path / "cluster.yaml.meta")


# ---- storage ops: slab destinations, meta-log metadata, scrub, GC ----

def make_storage_yaml(root, backend="torch", name="storage.yaml"):
    """3 ``slab:`` + 2 ``path`` destinations, ``meta-log`` metadata,
    4 KiB digest blocks, 16 KiB chunks."""
    dests = []
    for i in range(5):
        d = root / f"{name}.disk{i}"
        d.mkdir(parents=True)
        dests.append(f"slab:{d}" if i < 3 else str(d))
    spec = {
        "destinations": [{"location": x} for x in dests],
        "metadata": {"type": "meta-log", "format": "yaml",
                     "path": str(root / f"{name}.meta")},
        "profiles": {"default": {"data": 3, "parity": 2,
                                 "chunk_size": 14}},
        "tunables": {"backend": backend, "repair_block_bytes": 4096},
    }
    path = root / name
    path.write_text(yaml.safe_dump(spec))
    return path, dests


def chunk_location(tmp_path, conf, name, ci):
    from chunky_bits_tpu_torch.file.location import Location

    part = ref_obj(tmp_path, conf, name)["parts"][0]
    return Location.parse((part["data"] + part["parity"])[ci]
                          ["locations"][0])


def flip(location, offset):
    path, base = ((location.slab_extent()[:2]) if location.is_slab()
                  else (location.target, 0))
    with open(path, "r+b") as f:
        f.seek(base + offset)
        byte = f.read(1)
        f.seek(base + offset)
        f.write(bytes([byte[0] ^ 0xFF]))


def storage_damage(tmp_path, conf):
    """Flip a byte in chunk 1 of ``a``'s first part; drop chunk 4 of
    ``dir/b``'s first part."""
    flip(chunk_location(tmp_path, conf, "a", 1), 5000)
    run(chunk_location(tmp_path, conf, "dir/b", 4).delete())


def test_storage_ops_end_to_end(tmp_path):
    """cp onto slab + path destinations with meta-log metadata, damage,
    ``scrub --once`` (one decode plan a damaged chunk), ``verify`` Valid,
    ``cat`` byte-identical, ``meta-compact``, ``ls`` through the
    meta-log, and ``find-unused-hashes`` over the slab and path roots:
    no live chunk listed; a deleted object's chunks are collected."""
    conf, dests = make_storage_yaml(tmp_path)
    a, b = payload(3 * 16384 + 100, 1), payload(2 * 16384, 2)
    cli(tmp_path, "cp", "-", f"{conf}#a", stdin=a)
    cli(tmp_path, "cp", "-", f"{conf}#dir/b", stdin=b)
    assert b"file\tValid" in cli(tmp_path, "verify", f"{conf}#a")[0]
    storage_damage(tmp_path, conf)
    assert b"file\tValid" not in cli(tmp_path, "verify", f"{conf}#a")[0]
    out = cli(tmp_path, "scrub", "--once", str(conf))[0].decode()
    assert "corrupt=1 repaired=2 plans=0c/2d/0m/0f" in out, out
    for name, data in (("a", a), ("dir/b", b)):
        report = cli(tmp_path, "verify", f"{conf}#{name}")[0]
        assert report.startswith(b"file\tValid"), report
        assert b"Invalid" not in report and b"Unavailable" not in report
        assert cli(tmp_path, "cat", f"{conf}#{name}")[0] == data
    report = json.loads(cli(tmp_path, "meta-compact", str(conf))[0])
    assert report["live_refs"] == 2
    assert cli(tmp_path, "ls", "-r", f"{conf}#.")[0].decode().split() == \
        [".", "a", "dir", "dir/b"]
    roots = dests
    gc = ["find-unused-hashes", "--grace-seconds", "0", f"{conf}#."]
    assert cli(tmp_path, *gc, "--", *roots)[0] == b""
    # a tombstoned object's chunks are orphans: listed, then collected
    from chunky_bits_tpu_torch.cluster.meta_log import get_store

    doomed = [f"sha256-{c['sha256']}" for p in
              ref_obj(tmp_path, conf, "dir/b")["parts"]
              for c in p["data"] + p["parity"]]
    get_store(str(tmp_path / "storage.yaml.meta")).tombstone("dir/b")
    assert sorted(cli(tmp_path, *gc, "--", *roots)[0].decode().split()) \
        == sorted(doomed)
    removed = cli(tmp_path, *gc[:1], "-r", *gc[1:], "--", *roots)[0]
    assert sorted(removed.decode().split()) == sorted(doomed)
    assert cli(tmp_path, *gc, "--", *roots)[0] == b""
    assert cli(tmp_path, "cat", f"{conf}#a")[0] == a


def test_scrub_on_cuda_without_a_card_writes_nothing(tmp_path):
    """The same damaged cluster on ``backend: cuda``: ``scrub --once``
    exits non-zero naming CUDA and leaves every store byte as it was (no
    CPU fallback); ``--no-repair`` still reports the damage."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    conf, dests = make_storage_yaml(tmp_path)
    cli(tmp_path, "cp", "-", f"{conf}#a", stdin=payload(3 * 16384, 3))
    flip(chunk_location(tmp_path, conf, "a", 0), 7)
    conf.write_text(conf.read_text().replace("backend: torch",
                                             "backend: cuda"))

    def snapshot():
        out = {}
        for dirpath, _dirs, files in os.walk(tmp_path):
            for f in files:
                with open(os.path.join(dirpath, f), "rb") as fh:
                    out[os.path.join(dirpath, f)] = fh.read()
        return out

    before = snapshot()
    _out, err = cli(tmp_path, "scrub", "--once", str(conf), rc=1)
    assert "CUDA is not available" in err, err
    assert snapshot() == before
    out = cli(tmp_path, "scrub", "--once", "--no-repair", str(conf))[0]
    assert b"corrupt=1 repaired=0" in out


@pytest.mark.parametrize("compactor", ["jax", "port"])
def test_meta_compact_output_opens_in_the_other_package(tmp_path,
                                                        compactor):
    """A path-store cluster migrated into a meta-log by one package's
    ``meta-compact --from-path-store`` (then compacted again after a
    deletion) opens in the other: listings and reads equal."""
    from chunky_bits_tpu.cluster.meta_log import get_store as jax_store

    conf = make_cluster_yaml(tmp_path, d=3, p=2, chunk_size=12)
    blobs = {f"d/o{i}": payload(5000 + 999 * i, 20 + i) for i in range(3)}
    for name, data in blobs.items():
        cli(tmp_path, "cp", "-", f"{conf}#{name}", stdin=data)
    spec = yaml.safe_load(conf.read_text())
    old_meta = spec["metadata"]["path"]
    spec["metadata"] = {"type": "meta-log", "format": "yaml",
                        "path": str(tmp_path / "log")}
    conf_log = tmp_path / "log.yaml"
    conf_log.write_text(yaml.safe_dump(spec))
    clis = {"jax": lambda *a, **k: call(jax_main, tmp_path, "--backend",
                                        "numpy", *a, **k),
            "port": lambda *a, **k: cli(tmp_path, *a, **k)}
    reader = "port" if compactor == "jax" else "jax"
    report = json.loads(clis[compactor](
        "meta-compact", str(conf_log), "--from-path-store", old_meta)[0])
    assert report["live_refs"] == 3
    jax_store(str(tmp_path / "log")).tombstone("d/o1")
    del blobs["d/o1"]
    assert json.loads(clis[compactor]("meta-compact", str(conf_log))[0]) \
        ["live_refs"] == 2
    listing = {side: clis[side]("ls", "-r", f"{conf_log}#.")[0]
               for side in clis}
    assert listing["jax"] == listing["port"]
    for name, data in blobs.items():
        assert clis[reader]("cat", f"{conf_log}#{name}")[0] == data
        with open(os.path.join(old_meta, name), "rb") as f:
            assert f.read() == run_store_read(tmp_path / "log", name)


def run_store_read(root, name):
    from chunky_bits_tpu_torch.cluster.meta_log import MetaLogStore

    return MetaLogStore(str(root)).read_bytes(name)


# ---- GC against concurrent ingest (tests/test_gc_race.py) ----

def gc_cluster(tmp_path):
    conf = make_cluster_yaml(tmp_path, d=3, p=2, chunk_size=16)
    disks = [str(tmp_path / f"cluster.yaml.disk{i}") for i in range(5)]
    return conf, disks


def gc_args(conf, disks, **over):
    from types import SimpleNamespace

    base = dict(source=[f"{conf}#."], hashes=disks, batch_size=2,
                remove=True, grace_seconds=30.0)
    base.update(over)
    return SimpleNamespace(**base)


def plant_orphan(disks, i, age=3600):
    data = b"orphan-%d" % i
    path = os.path.join(disks[i % len(disks)],
                        "sha256-" + hashlib.sha256(data).hexdigest())
    with open(path, "wb") as f:
        f.write(data)
    if age:
        old = time.time() - age
        os.utime(path, (old, old))
    return path


def test_gc_never_eats_inflight_writes(tmp_path):
    from chunky_bits_tpu_torch.cli.config import Config
    from chunky_bits_tpu_torch.cli.main import find_unused_hashes

    conf, disks = gc_cluster(tmp_path)
    rng = random.Random(1234)
    payloads = {f"f{i}": rng.randbytes(rng.randrange(2000, 10000))
                for i in range(6)}
    orphans = [plant_orphan(disks, i) for i in range(3)]

    async def main():
        config = await Config.load_or_default(str(tmp_path / "config.yaml"))
        cluster = await config.get_cluster(str(conf))

        async def writer():
            for name, data in payloads.items():
                await cluster.write_file(name, aio.BytesReader(data),
                                         cluster.get_profile(None))
                await asyncio.sleep(0)

        async def gc_loop():
            for _ in range(4):
                await find_unused_hashes(config, gc_args(conf, disks))
                await asyncio.sleep(0)

        await asyncio.gather(writer(), gc_loop())
        await find_unused_hashes(config, gc_args(conf, disks))
        for name, data in payloads.items():
            got = await cluster.file_read_builder(
                await cluster.get_file_ref(name)).read_all()
            assert got == data, name

    run(main())
    assert not any(os.path.exists(p) for p in orphans)


def test_gc_grace_window_and_delete_time_recheck(tmp_path, monkeypatch):
    """A fresh unreferenced chunk survives a --remove pass and is
    collected with the window off; a listed orphan re-written before its
    delete is spared; a crashed writer's old temp is reaped, a live one
    and unknown names are left alone."""
    from chunky_bits_tpu_torch.cli import main as cli_main
    from chunky_bits_tpu_torch.cli.config import Config
    from chunky_bits_tpu_torch.file.location import (is_publish_temp,
                                                     publish_temp_name)

    conf, disks = gc_cluster(tmp_path)
    fresh = plant_orphan(disks, 0, age=0)
    rewritten = plant_orphan(disks, 1)
    stale = os.path.join(disks[2], "sha256-" + "a" * 64 + ".tmp.1.deadbeef")
    live = os.path.join(disks[3], "sha256-" + "b" * 64 + ".tmp.2.cafebabe")
    unknown = os.path.join(disks[4], "notes.txt")
    for p in (stale, live, unknown):
        with open(p, "wb") as f:
            f.write(b"x")
    old = time.time() - 3600
    os.utime(stale, (old, old))
    os.utime(unknown, (old, old))
    real_stat = os.stat
    bumped = []

    def stat_with_rewrite(p, *a, **kw):
        st = real_stat(p, *a, **kw)
        if p == rewritten and not bumped:
            bumped.append(True)
            os.utime(rewritten, None)
        return st

    async def main():
        config = await Config.load_or_default(str(tmp_path / "config.yaml"))
        monkeypatch.setattr(cli_main.os, "stat", stat_with_rewrite)
        await cli_main.find_unused_hashes(config, gc_args(conf, disks))
        monkeypatch.setattr(cli_main.os, "stat", real_stat)
        assert os.path.exists(fresh) and os.path.exists(rewritten)
        assert not os.path.exists(stale)
        assert os.path.exists(live) and os.path.exists(unknown)
        await cli_main.find_unused_hashes(
            config, gc_args(conf, disks, grace_seconds=0.0))

    run(main())
    assert not os.path.exists(fresh) and os.path.exists(unknown)
    name = publish_temp_name("/x/sha256-" + "a" * 64)
    assert is_publish_temp(os.path.basename(name))
    assert not is_publish_temp("sha256-" + "a" * 64)
    assert not is_publish_temp("notes.txt")


def test_run_closes_every_http_session_it_opened(tmp_path, monkeypatch):
    """``cp`` and ``cat`` through a cluster of ``http://`` destinations
    (``tests/http_node.py``): when ``run`` returns, while its loop is
    still alive, every aiohttp session the command opened is closed (the
    config's cached clusters and ``default_context()``, as the JAX
    package's ``run`` closes them)."""
    import threading

    from chunky_bits_tpu_torch.cli import main as cli_main
    from chunky_bits_tpu_torch.file.location import LocationContext
    from tests.http_node import FakeHttpNode

    loop = asyncio.new_event_loop()
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()

    def on_loop(coro):
        return asyncio.run_coroutine_threadsafe(coro, loop).result(60)

    sessions, at_return = [], []
    opened = LocationContext.http_session

    def http_session(self):
        sess = opened(self)
        if sess not in sessions:
            sessions.append(sess)
        return sess

    real_run = cli_main.run

    async def run_and_look(args):
        try:
            return await real_run(args)
        finally:
            at_return.append([s.closed for s in sessions])

    monkeypatch.setattr(LocationContext, "http_session", http_session)
    monkeypatch.setattr(cli_main, "run", run_and_look)
    nodes = [on_loop(FakeHttpNode().start()) for _ in range(5)]
    try:
        meta = tmp_path / "meta"
        meta.mkdir()
        conf = tmp_path / "http.yaml"
        conf.write_text(yaml.safe_dump({
            "destinations": [{"location": f"{n.url}/d{i}/"}
                             for i, n in enumerate(nodes)],
            "metadata": {"type": "path", "format": "yaml",
                         "path": str(meta)},
            "profiles": {"default": {"data": 3, "parity": 2,
                                     "chunk_size": 12}}}))
        payload = bytes(range(256)) * 97
        cli(tmp_path, "cp", "-", f"{conf}#obj", stdin=payload)
        out, _err = cli(tmp_path, "cat", f"{conf}#obj")
        assert out == payload
    finally:
        for n in nodes:
            on_loop(n.stop())
        loop.call_soon_threadsafe(loop.stop)
        thread.join(10)
        loop.close()
    assert len(at_return) == 2 and sessions
    assert all(all(closed) for closed in at_return), at_return
