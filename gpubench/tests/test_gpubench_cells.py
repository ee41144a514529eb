"""A CPU rehearsal of every cell: each runs end to end at a tiny size on
the port's ``torch`` backend and gives a well-formed result line; and the
command itself, asked for a card that is not there, fails and prints no
result."""

import json
import os
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from gpubench import manifest, rehearsal  # noqa: E402

BENCH = manifest.load(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 4099


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def well_formed(result: dict) -> None:
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checked"
    assert isinstance(result["correct"], bool)
    assert result["attempted"] > 0 and result["failed"] >= 0
    for name, m in result["metrics"].items():
        assert isinstance(m["value"], float) and m["unit"], name
    dev = result["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for name, c in result["checked"].items():
        assert set(c) == {"value", "limit"}, name
    json.dumps(result)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_rehearses_on_the_cpu(workload):
    result, lines = rehearsal.run_tiny(workload, SEED)
    well_formed(result)
    assert result["correct"], result["checked"]
    assert result["device"]["platform"] == "cpu"
    want = {m["name"] for m in manifest.metrics(BENCH, workload, False)}
    assert set(result["metrics"]) == want
    assert lines[-len(result["checked"]):] == [
        f"check {k} {v['value']} limit {v['limit']}"
        for k, v in result["checked"].items()]


@pytest.mark.parametrize("workload", CELLS)
def test_traced_rehearsal_reports_what_the_cpu_can(workload):
    """On the CPU there is no device trace: the device metrics stay out
    of the line, and the counters and host clocks are there."""
    result, _ = rehearsal.run_tiny(workload, SEED + 1, trace=1)
    well_formed(result)
    assert result["correct"]
    assert result["device"]["busy_s"] == 0.0
    per_layer = {m["name"]: m for m in manifest.metrics(BENCH, workload,
                                                        True)}
    assert set(result["metrics"]) <= set(per_layer)
    assert not any(per_layer[n]["source"] == "device_trace"
                   for n in result["metrics"])
    assert "breakdown" not in result


def test_without_a_card_the_command_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA card" in proc.stderr


def test_an_unknown_cell_fails():
    proc = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload", "no-such",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.parametrize("workload", CELLS)
def test_every_reader_reads_or_stays_silent(workload):
    """Each reader in ``gpubench/metrics/`` gives a number or nothing on
    every cell's run, and the cell's rate and set-up are numbers."""
    from gpubench import generator

    cell, config, traffic = rehearsal.tiny(BENCH, workload)
    run, _, _ = generator.run_cell(cell["name"], config, traffic, SEED + 2,
                                   1.0, True, time.monotonic(),
                                   backend="torch", device="cpu")
    values = {}
    for name in sorted(os.listdir(os.path.join(ROOT, "gpubench",
                                               "metrics"))):
        if name.endswith(".py"):
            value = manifest.reader(name[:-3], ROOT)(run)
            assert value is None or (isinstance(value, float)
                                     and value >= 0), name
            values[name[:-3]] = value
    assert values["ingest_gib_s"] > 0 and values["setup_s"] > 0
