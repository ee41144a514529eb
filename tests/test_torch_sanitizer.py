"""The port's runtime concurrency sanitizer
(``chunky_bits_tpu_torch/analysis/sanitizer.py``) and its hooks in the
host pipeline, the gateway's ``serve`` and ``sim.run``: the mirror of
``tests/test_sanitizer.py`` plus cross-package checks.

Pins the three monitors' detection behavior (leaked tasks, swallowed task
exceptions, loop stalls, handoff violations), the watchdog's contract
against dead loops, and the off-by-default zero-overhead contract: with
``CHUNKY_BITS_TORCH_SANITIZE`` unset the instrumentation module is never
imported, and the JAX package's ``CHUNKY_BITS_TPU_SANITIZE`` never turns
it on.  A seeded scenario gives the same trace bytes with the sanitizer
off and on, and a report whose counts equal the JAX package's sanitized
run of the same scenario.

Deliberate-violation end-to-end checks run in subprocesses: the global
sanitizer is process-wide, and a violation recorded in this process would
outlive the test.  Every wait is bounded: subprocesses by their timeout,
in-process loops by ``tests/test_torch_file.py::bounded``.
"""

from __future__ import annotations

import asyncio
import gc
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from chunky_bits_tpu_torch.analysis.sanitizer import (
    HandoffChecker,
    LoopWatchdog,
    TaskRegistry,
)
from tests.test_torch_file import bounded

REPO = Path(__file__).resolve().parents[1]

#: seconds a subprocess may take before the test fails
SUBPROCESS_TIMEOUT = 120


def _run_py(code: str, *, sanitize: str | None,
            jax_sanitize: str | None = None) -> subprocess.CompletedProcess:
    """``python -c code`` from the repo root, with ``sanitize`` as
    ``CHUNKY_BITS_TORCH_SANITIZE`` and ``jax_sanitize`` as the JAX
    package's ``CHUNKY_BITS_TPU_SANITIZE`` (None = unset).  Torch gets one
    intra-op thread and the port's default backend is ``torch``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("CHUNKY_BITS_")}
    env["CHUNKY_BITS_TORCH_BACKEND"] = "torch"
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    if sanitize is not None:
        env["CHUNKY_BITS_TORCH_SANITIZE"] = sanitize
    if jax_sanitize is not None:
        env["CHUNKY_BITS_TPU_SANITIZE"] = jax_sanitize
    return subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=SUBPROCESS_TIMEOUT, cwd=str(REPO), env=env)


def _last_json(proc: subprocess.CompletedProcess) -> dict:
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


# ---- off-by-default: zero overhead ----

def test_flag_unset_never_imports_instrumentation():
    """The sanitize-off path must not even import the sanitizer module:
    the whole cost is one sys.modules dict lookup per job."""
    proc = _run_py("""
import sys
from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline

pipe = HostPipeline(threads=2)
jobs = [pipe.submit("t", lambda i=i: i * i) for i in range(8)]
assert [j.wait() for j in jobs] == [i * i for i in range(8)]
import asyncio


async def body():
    return await pipe.run("t", lambda: 41 + 1)


assert asyncio.run(body()) == 42
pipe.close()
assert "chunky_bits_tpu_torch.analysis.sanitizer" not in sys.modules, \\
    "sanitizer imported with the flag unset"
print("ZERO_OVERHEAD_OK")
""", sanitize=None)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ZERO_OVERHEAD_OK" in proc.stdout


def test_flag_unset_hook_modules_never_import_instrumentation():
    """The gateway, the host pipeline and the simulator hold the three
    hooks; importing them, and running a pipeline job and a ``sim.run``,
    leaves the sanitizer unloaded when the flag is unset."""
    proc = _run_py("""
import asyncio, sys
from chunky_bits_tpu_torch.gateway import http, serve
from chunky_bits_tpu_torch.parallel import host_pipeline
from chunky_bits_tpu_torch import sim
from chunky_bits_tpu_torch.sim import scenario


async def body(pipe):
    await asyncio.sleep(5.0)
    return await pipe.run("t", lambda: 6 * 7, nbytes=1 << 20)


pipe = host_pipeline.HostPipeline(threads=1)
assert sim.run(body(pipe)) == 42
pipe.close()
assert "chunky_bits_tpu_torch.analysis.sanitizer" not in sys.modules
print("HOOKS_OFF_OK")
""", sanitize=None)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "HOOKS_OFF_OK" in proc.stdout


def test_reference_flag_leaves_port_uninstrumented():
    """``CHUNKY_BITS_TPU_SANITIZE=1`` configures the JAX package only: the
    port builds its pipeline and runs its loops uninstrumented."""
    proc = _run_py("""
import sys
from chunky_bits_tpu_torch.cluster.tunables import sanitize_enabled
from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline
from chunky_bits_tpu_torch import sim


async def body():
    return 7


pipe = HostPipeline(threads=1)
assert pipe.submit("t", lambda: 7).wait() == 7
assert sim.run(body()) == 7
pipe.close()
assert not sanitize_enabled()
assert "chunky_bits_tpu_torch.analysis.sanitizer" not in sys.modules
print("PORT_OFF_OK")
""", sanitize=None, jax_sanitize="1")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PORT_OFF_OK" in proc.stdout


def test_flag_set_activates_via_pipeline_construction():
    proc = _run_py("""
import sys
from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline

pipe = HostPipeline(threads=2)
assert "chunky_bits_tpu_torch.analysis.sanitizer" in sys.modules
from chunky_bits_tpu_torch.analysis import sanitizer

assert sanitizer.active() is not None
assert pipe.submit("t", lambda: 7).wait() == 7
report = sanitizer.report()
assert report.ok(), report.render()
pipe.close()
print("ACTIVATED_OK")
""", sanitize="1")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ACTIVATED_OK" in proc.stdout


# ---- task registry ----

def test_leaked_task_detection_fires():
    reg = TaskRegistry()
    loop = asyncio.new_event_loop()
    reg.install_on_loop(loop)

    async def forever() -> None:
        await asyncio.Event().wait()

    async def spawn() -> asyncio.Task:
        task = asyncio.get_running_loop().create_task(forever())
        await asyncio.sleep(0)
        return task

    task = loop.run_until_complete(spawn())
    try:
        leaks = reg.pending_leaks()
        assert len(leaks) == 1
        # the creation site points at THIS file, not asyncio internals
        assert "test_torch_sanitizer" in leaks[0]
    finally:
        task.cancel()
        with pytest.raises(asyncio.CancelledError):
            loop.run_until_complete(task)
        loop.close()
    assert reg.pending_leaks() == []


def test_unretrieved_task_exception_captured():
    reg = TaskRegistry()
    loop = asyncio.new_event_loop()
    reg.install_on_loop(loop)

    async def boom() -> None:
        raise RuntimeError("swallowed?")

    async def spawn_and_drop() -> None:
        asyncio.get_running_loop().create_task(boom())  # lint: task-leak-ok the leak IS the fixture
        await asyncio.sleep(0.01)

    loop.run_until_complete(spawn_and_drop())
    loop.close()
    gc.collect()
    events = reg.events()
    assert any("never retrieved" in e for e in events), events
    assert any("swallowed?" in e for e in events), events


def test_done_tasks_are_not_leaks():
    reg = TaskRegistry()
    loop = asyncio.new_event_loop()
    reg.install_on_loop(loop)

    async def work() -> int:
        return 7

    async def body() -> int:
        return await asyncio.get_running_loop().create_task(work())

    assert loop.run_until_complete(body()) == 7
    loop.close()
    assert reg.pending_leaks() == []
    assert reg.events() == []


# ---- watchdog ----

@pytest.mark.filterwarnings("ignore")
def test_watchdog_detects_blocked_loop():
    wd = LoopWatchdog(threshold=0.1, interval=0.02)

    def run() -> None:
        loop = asyncio.new_event_loop()

        async def body() -> None:
            wd.watch(asyncio.get_running_loop())
            await asyncio.sleep(0.1)  # let a heartbeat land
            time.sleep(0.5)  # block the loop: the hazard
            await asyncio.sleep(0.05)

        loop.run_until_complete(body())
        loop.close()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    thread.join(timeout=10)
    assert not thread.is_alive()
    wd.stop()
    assert wd.stalls, "blocked loop went undetected"
    assert "unresponsive" in wd.stalls[0]


def test_watchdog_never_hangs_on_dead_or_closed_loop():
    """A loop that exists but never runs records nothing; a closed loop
    is dropped; stop() returns promptly either way."""
    wd = LoopWatchdog(threshold=0.05, interval=0.02)
    dead = asyncio.new_event_loop()
    wd.watch(dead)
    time.sleep(0.3)
    assert wd.stalls == []  # not running -> not stalled
    dead.close()
    time.sleep(0.1)  # watchdog notices the close and drops it
    t0 = time.monotonic()
    wd.stop()
    assert time.monotonic() - t0 < 2.0
    assert wd.stalls == []


def test_watchdog_healthy_loop_records_nothing():
    wd = LoopWatchdog(threshold=0.25, interval=0.02)

    async def body() -> None:
        wd.watch(asyncio.get_running_loop())
        for _ in range(10):
            await asyncio.sleep(0.02)

    bounded(lambda: asyncio.run(body()), 30)
    wd.stop()
    assert wd.stalls == []


# ---- handoff checker ----

def test_sync_wait_on_loop_thread_recorded():
    hc = HandoffChecker()

    async def body() -> None:
        hc.check_sync_wait("_Job.join()")

    bounded(lambda: asyncio.run(body()), 30)
    assert len(hc.violations) == 1
    assert "event-loop thread" in hc.violations[0]
    # off-loop sync waits are the intended shape: no violation
    hc2 = HandoffChecker()
    hc2.check_sync_wait("_Job.join()")
    assert hc2.violations == []


def test_resolve_on_wrong_thread_recorded():
    hc = HandoffChecker()

    async def body() -> None:
        token = hc.submit_token()
        hc.check_resolve(token)  # same loop + thread: fine
        assert hc.violations == []
        thread = threading.Thread(target=hc.check_resolve,
                                  args=(token,), daemon=True)
        thread.start()
        await asyncio.to_thread(thread.join, 10)

    bounded(lambda: asyncio.run(body()), 30)
    assert len(hc.violations) == 1
    assert "off the submitting side" in hc.violations[0]
    assert (hc.submits, hc.resolves) == (1, 2)


# ---- end-to-end through the pipeline (subprocesses: deliberate
# violations must not land in this process's global report) ----

def test_pipeline_async_path_is_handoff_clean():
    proc = _run_py("""
import asyncio
import numpy as np
from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline
from chunky_bits_tpu_torch.analysis import sanitizer

pipe = HostPipeline(threads=2)


async def body():
    big = 1 << 20  # > INLINE_NBYTES: forces the worker hop + bridge
    out = await pipe.run("t", lambda: sum(range(100)), nbytes=big)
    assert out == 4950
    # an inline job is recorded and checked too
    assert await pipe.run("t", lambda: 5, nbytes=1) == 5


asyncio.run(body())

# the sync scatter APIs are for off-loop callers; with no loop running
# on this thread they record nothing
rows = np.zeros((8, 4096), dtype=np.uint8)
digests = np.empty((8, 32), dtype=np.uint8)
from chunky_bits_tpu_torch.parallel.host_pipeline import join_jobs

join_jobs(pipe.hash_rows_jobs(rows, digests))
report = sanitizer.report()
assert report.handoff_violations == [], report.render()
assert report.leaked_tasks == [], report.render()
handoff = sanitizer.active().handoff
assert (handoff.submits, handoff.resolves) == (2, 2), handoff.submits
pipe.close()
print("CLEAN_OK")
""", sanitize="1")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "CLEAN_OK" in proc.stdout


def test_pipeline_sync_wait_on_loop_detected_end_to_end():
    proc = _run_py("""
import asyncio
import time
from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline
from chunky_bits_tpu_torch.analysis import sanitizer

pipe = HostPipeline(threads=2)


async def body():
    job = pipe.submit("t", lambda: time.sleep(0.2) or 7)
    assert job.wait() == 7  # blocking the loop: the violation


asyncio.run(body())
report = sanitizer.report()
assert report.handoff_violations, "sync loop-thread wait undetected"
assert "event-loop thread" in report.handoff_violations[0]
pipe.close()
print("DETECTED_OK")
""", sanitize="1")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DETECTED_OK" in proc.stdout


def test_whole_batch_device_route_on_loop_detected():
    """The port's whole-batch ``encode_hash_sync`` route (a backend with
    its own ``encode_and_hash`` gets the batch in one call on the calling
    thread) blocks the loop when called from it: the sanitizer records
    that; off the loop, through ``encode_hash``, the same batch is clean
    and byte-identical."""
    proc = _run_py("""
import asyncio
import numpy as np
from chunky_bits_tpu_torch.ops.backend import get_coder
from chunky_bits_tpu_torch.parallel.host_pipeline import HostPipeline
from chunky_bits_tpu_torch.analysis import sanitizer

pipe = HostPipeline(threads=2)
coder = get_coder(3, 2, "torch")
stacked = np.random.default_rng(5).integers(0, 256, (4, 3, 512),
                                            dtype=np.uint8)


async def off_loop():
    return await pipe.encode_hash(coder, stacked)


clean = asyncio.run(off_loop())
assert sanitizer.report().handoff_violations == []


async def on_loop():
    return pipe.encode_hash_sync(coder, stacked)  # blocks the loop


blocked = asyncio.run(on_loop())
for a, b in zip(clean, blocked):
    assert np.array_equal(a, b)
violations = sanitizer.report().handoff_violations
assert len(violations) == 1 and "encode_hash_sync()" in violations[0], \\
    violations
pipe.close()
print("WHOLE_BATCH_OK")
""", sanitize="1")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "WHOLE_BATCH_OK" in proc.stdout


def test_hooks_fire_in_pipeline_serve_and_sim_run(tmp_path):
    """With the port's flag set: a pipeline's construction installs the
    sanitizer, ``sim.run`` instruments its virtual-time loop, and
    ``serve`` instruments the serving loop, whose PUT and GET record
    handoff submits; the report stays clean."""
    code = """
import asyncio, json, pathlib, sys
from aiohttp import ClientSession
from chunky_bits_tpu_torch import sim
from chunky_bits_tpu_torch.cluster import Cluster
from chunky_bits_tpu_torch.gateway import serve
from chunky_bits_tpu_torch.parallel.host_pipeline import get_host_pipeline
from tests.test_torch_gateway import cluster_spec

get_host_pipeline()
from chunky_bits_tpu_torch.analysis import sanitizer
san = sanitizer.active()
assert san is not None


def instrumented(loop):
    return (loop.get_task_factory() == san.tasks._factory
            and id(loop) in san.watchdog._beats)


async def in_sim():
    await asyncio.sleep(60.0)  # virtual
    return instrumented(asyncio.get_running_loop())


assert sim.run(in_sim())
cluster = Cluster.from_obj(cluster_spec(pathlib.Path(TMP)))
payload = bytes(range(256)) * 4096  # 1 MiB: the stage job leaves the loop


async def in_serve():
    ready = asyncio.get_running_loop().create_future()
    task = asyncio.ensure_future(serve(
        cluster, "127.0.0.1", 0, on_ready=lambda port: ready.set_result(port)))
    port = await asyncio.wait_for(ready, 30)
    try:
        before = san.handoff.submits
        async with ClientSession() as session:
            url = f"http://127.0.0.1:{port}/obj"
            resp = await asyncio.wait_for(session.put(url, data=payload), 30)
            assert resp.status == 200, resp.status
            resp = await asyncio.wait_for(session.get(url), 30)
            assert await resp.read() == payload
        return (instrumented(asyncio.get_running_loop()),
                san.handoff.submits - before)
    finally:
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)


on_loop, submits = asyncio.run(in_serve())
assert on_loop and submits >= 1, (on_loop, submits)
report = sanitizer.report()
assert report.ok(), report.render()
print(json.dumps({"submits": san.handoff.submits}))
""".replace("TMP", repr(str(tmp_path)))
    out = _last_json(_run_py(code, sanitize="1"))
    assert out["submits"] >= 1


#: one seeded scenario through both packages: the trace's SHA-256, its
#: length, every verdict and the sanitizer report's counts
_SCENARIO = """
import hashlib, json, sys
PKG_IMPORTS
def counts(report):
    return {"leaked_tasks": len(report.leaked_tasks),
            "unretrieved_exceptions": len(report.unretrieved_exceptions),
            "handoff_violations": len(report.handoff_violations)}


def one():
    r = run_scenario("az_outage", nodes=12, seed=0, objects=6,
                     workdir=fresh_workdir(WORKDIR))
    return {"sha": hashlib.sha256(r.trace).hexdigest(), "bytes": len(r.trace),
            "ok": r.ok(), "verdicts": r.verdicts}


out = {}
BODY
print(json.dumps(out))
"""

_PORT_BODY = """
out["off"] = one()
assert "chunky_bits_tpu_torch.analysis.sanitizer" not in sys.modules
from chunky_bits_tpu_torch.analysis import sanitizer
san = sanitizer.install()
out["on"] = one()
out["report"] = counts(sanitizer.report())
out["stalls"] = len(sanitizer.report().stalls)
out["submits"] = san.handoff.submits
"""

_JAX_BODY = """
out["on"] = one()
from chunky_bits_tpu.analysis import sanitizer
assert sanitizer.active() is not None
out["report"] = counts(sanitizer.report())
"""


def test_sanitized_scenario_trace_and_report_match(tmp_path):
    """``az_outage`` at N=12, seed 0, on ``torch``: the trace bytes with
    the sanitizer off and on are identical, the sanitized run is clean
    with every job's handoff recorded, and its report's counts (and the
    trace) equal the JAX package's run under
    ``CHUNKY_BITS_TPU_SANITIZE=1``."""
    workdir = repr(str(tmp_path / "scenario"))
    port = _last_json(_run_py(
        _SCENARIO.replace("PKG_IMPORTS", (
            "import torch\ntorch.set_num_threads(1)\n"
            "from chunky_bits_tpu_torch.sim.scenario import (fresh_workdir,"
            " run_scenario)\n"))
        .replace("WORKDIR", workdir).replace("BODY", _PORT_BODY),
        sanitize=None))
    ref = _last_json(_run_py(
        _SCENARIO.replace("PKG_IMPORTS", (
            "from chunky_bits_tpu.sim.scenario import (fresh_workdir,"
            " run_scenario)\n"))
        .replace("WORKDIR", workdir).replace("BODY", _JAX_BODY),
        sanitize=None, jax_sanitize="1"))
    assert port["off"]["ok"] and port["on"]["ok"], port
    assert port["on"] == port["off"]
    assert port["submits"] > 0
    assert port["report"] == {"leaked_tasks": 0,
                              "unretrieved_exceptions": 0,
                              "handoff_violations": 0}
    assert port["report"] == ref["report"]
    assert port["on"] == ref["on"]
