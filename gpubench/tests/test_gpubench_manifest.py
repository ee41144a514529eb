"""``BENCHMARK.json`` keeps the contract's rules, and the harness is
driven by data: a new configuration, traffic mix and per-layer metric are
found by their names, as new files, with no file of the harness edited;
so is a new operation, as a new file of ``traffic/``."""

import hashlib
import json
import os
import re
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpubench import manifest, rehearsal  # noqa: E402

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    RAW = _f.read()
BENCH = json.loads(RAW)
E2E = {m["name"]: m for m in BENCH["end_to_end"]}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def line_text(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(RAW.encode()) <= 64 << 10
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for path in BENCH["paths"]:
        assert len(path) <= 200 and not path.startswith("/")
        assert ".." not in path.split("/")
        assert os.path.isdir(os.path.join(ROOT, path))
    assert len(BENCH["command"]) <= 32
    assert all(line_text(word) for word in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_every_name_and_unit_keeps_the_rules():
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [w["config"] for w in BENCH["workloads"]]
    names += [w["traffic"] for w in BENCH["workloads"]]
    names += [k for c in BENCH["configs"] for k in c["reduced"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    for name in names:
        assert NAME_RE.match(name), name
    for m in metrics:
        assert UNIT_RE.match(m["unit"]), m
        assert len(m["unit"]) <= 16
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for kind in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[kind]}) == len(BENCH[kind])
    assert len({m["name"] for m in metrics}) == len(metrics)


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_text(c["source"]) and line_text(c["why"])
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        for key in c["reduced"]:
            assert key in cfg and key in cfg["reduced_from_source"], key
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line_text(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert line_text(m["layer"]) and m["moves"] in E2E


def test_cells_are_whole():
    configs = {c["name"] for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(BENCH["workloads"])
    four = sum(1 for w in BENCH["workloads"] if w["chips"] == 4)
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for w in BENCH["workloads"]:
        cell, config, traffic = manifest.cell(BENCH, w["name"], ROOT)
        e2e = {m["name"] for m in manifest.metrics(BENCH, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert manifest.metrics(BENCH, w["name"], True), w["name"]
        for m in manifest.metrics(BENCH, w["name"], True):
            assert m["moves"] in e2e, (w["name"], m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert w in {c["name"] for c in BENCH["workloads"]}
        assert callable(manifest.reader(m["name"], ROOT))


def tree_digest(root: str) -> dict:
    out = {}
    for base, dirs, files in os.walk(os.path.join(root, "gpubench")):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for name in files:
            path = os.path.join(base, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@pytest.fixture
def copy_root(tmp_path):
    dst = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "gpubench"), dst / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    return str(dst)


def test_new_pieces_are_found_by_name(copy_root):
    import torch

    before = tree_digest(copy_root)
    base = os.path.join(copy_root, "gpubench")
    with open(os.path.join(base, "configs", "hdfs-rs-10-4-1024k.json")) as f:
        cfg = json.load(f)
    cfg.update(name="example-rs-6-3", data=6, parity=3, destinations=9)
    with open(os.path.join(base, "configs", "example-rs-6-3.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(base, "traffic", "two-writers.json"), "w") as f:
        json.dump({"op": "write", "clients": 2, "warmup": 1,
                   "blob_bytes": 1 << 20, "check_per_client": 2}, f)
    with open(os.path.join(base, "metrics", "objects_per_s.example.py"),
              "w") as f:
        f.write("def read(run):\n"
                "    done = run.in_window('write')\n"
                "    return len(done) / run.window_s if done else None\n")
    with open(os.path.join(copy_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({
        "name": "example-rs-6-3", "source": "https://example.org/rs-6-3",
        "file": "gpubench/configs/example-rs-6-3.json", "reduced": [],
        "why": "an added configuration"})
    bench["workloads"].append({
        "name": "rs6-3.two-writers", "config": "example-rs-6-3",
        "traffic": "two-writers", "chips": 1, "why": "an added cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "ingest_gib_s":
            m["workloads"].append("rs6-3.two-writers")
    bench["per_layer"].append({
        "name": "objects_per_s.example", "unit": "objects/s",
        "better": "higher", "source": "host_clock", "layer": "Object codec",
        "moves": "ingest_gib_s", "workloads": ["rs6-3.two-writers"]})
    with open(os.path.join(copy_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    after = tree_digest(copy_root)
    assert {k: v for k, v in after.items() if k in before} == before
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, _ = rehearsal.run_tiny("rs6-3.two-writers", 2**31 + 5,
                                       trace=1, root=copy_root)
    finally:
        torch.set_num_threads(threads)
    assert result["correct"]
    assert result["metrics"]["objects_per_s.example"]["value"] > 0
    assert result["metrics"]["objects_per_s.example"]["unit"] == "objects/s"


#: an operation that no file of the harness knows: each client stores a
#: small object through the cluster and reads it back through its reader
PUT_GET = '''
import time

from gpubench.generator import ClosedLoop, source_bytes
from gpubench.record import Op


class Traffic:
    kind = "put_get"

    def __init__(self, ctx):
        self.ctx = ctx
        self.obj = int(ctx.run.traffic["object_bytes"])
        self.loop = ClosedLoop(int(ctx.run.traffic["clients"]), 1)
        self.keys = 0

    async def prepare(self):
        return None

    async def run(self, win, ops):
        from gpubench.generator import CyclicSource

        async def step(c, j):
            key, self.keys = self.keys, self.keys + 1
            op = Op(self.kind, key, self.obj, time.monotonic())
            path = f"pg/{key}"
            await self.ctx.cluster.write_file(
                path, CyclicSource(self.ctx.blob, self.obj, key * self.obj),
                self.ctx.profile)
            ref = await self.ctx.cluster.get_file_ref(path)
            got = b"".join([bytes(b) async for b in
                            self.ctx.cluster.file_read_builder(ref).stream()])
            op.t1, op.ok, op.answer = time.monotonic(), True, got
            op.window_bytes = win.count(op.t1, self.obj)
            ops.append(op)

        await self.loop.run(win, step)

    def counters(self):
        return {}

    async def close(self):
        return None

    def check(self, run):
        due = run.due(self.kind)
        bad = sum(op.answer != source_bytes(self.ctx.blob,
                                            op.key * self.obj, self.obj)
                  for op in due)
        return {"byte_mismatches": (bad, 0), "reads_checked": (len(due),
                                                               None)}
'''


def test_a_new_operation_is_found_by_name(copy_root):
    """A cell whose mix names an operation that only a new file of
    ``gpubench/traffic/`` defines runs, and its check decides."""
    import torch

    before = tree_digest(copy_root)
    base = os.path.join(copy_root, "gpubench")
    with open(os.path.join(base, "traffic", "put_get.py"), "w") as f:
        f.write(PUT_GET)
    with open(os.path.join(base, "traffic", "put-get.json"), "w") as f:
        json.dump({"op": "put_get", "clients": 2, "object_bytes": 5000,
                   "warmup": 1, "blob_bytes": 1 << 20}, f)
    with open(os.path.join(base, "metrics", "round_trips_per_s.py"),
              "w") as f:
        f.write("def read(run):\n"
                "    done = run.in_window('put_get')\n"
                "    return len(done) / run.window_s if done else None\n")
    with open(os.path.join(copy_root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({
        "name": "rs10-4.put-get", "config": "hdfs-rs-10-4-1024k",
        "traffic": "put-get", "chips": 1, "why": "an added operation"})
    bench["per_layer"].append({
        "name": "round_trips_per_s", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "Object codec",
        "moves": "setup_s", "workloads": ["rs10-4.put-get"]})
    with open(os.path.join(copy_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)

    after = tree_digest(copy_root)
    assert {k: v for k, v in after.items() if k in before} == before
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result, _ = rehearsal.run_tiny("rs10-4.put-get", 2**31 + 6,
                                       trace=1, root=copy_root)
    finally:
        torch.set_num_threads(threads)
    assert result["correct"], result["checked"]
    assert result["checked"]["reads_checked"]["value"] > 0
    assert result["metrics"]["round_trips_per_s"]["value"] > 0
