"""The one traffic generator.  A mix (``traffic/<mix>.json``) is data: it
names an operation under ``op`` and gives its parameters.  The operation
is found by that name, as ``traffic/<op>.py``, the way a metric's reader
is found in ``metrics/``, so a later cell can bring an operation of its
own by adding a file.  This module holds what every operation shares:
the seeded source bytes, the cluster, the closed loops that warm up and
run on through the timed window without a pause, the window itself, and
the run that drives an operation and reads the program's counters at the
window's edges.

An operation module defines ``Traffic``, built as ``Traffic(ctx)`` from
a :class:`Context` (set-up that needs no event loop, from the seed), with:

* ``kind``: the name its requests carry (``Op.kind``);
* ``loop``: its :class:`ClosedLoop`, whose ``warm`` event opens the
  window;
* ``async prepare()``: set-up on the event loop;
* ``async run(win, ops)``: the closed loops, appending one ``Op`` per
  request, from the warm-up through the window's close;
* ``counters()``: the program's counters, read at the window's edges;
* ``async close()``: stop what ``prepare`` started;
* ``check(run)``: after the window, each number compared, by name, as
  ``(value, limit)`` (a limit of ``None`` is a count that must not be 0).

The spans that the harness records around calls into each layer go to
``ctx.spans``.
"""

from __future__ import annotations

import asyncio
import importlib.util
import os
import random
import re
import resource
import shutil
import tempfile
import time
from typing import Optional

import numpy as np

from gpubench import faults
from gpubench.record import Run, Spans

#: seconds a run waits past the window's close for answers in flight
DRAIN_S = 60.0
HERE = os.path.dirname(os.path.abspath(__file__))


class CyclicSource:
    """``total`` bytes cycling through the blob from ``start``, served
    through ``readinto`` (one copy into the writer's staging, as a socket
    reader would): the smoke script's ``CyclicSource``, copied, with a
    start offset."""

    def __init__(self, blob: memoryview, total: int, start: int = 0):
        self.blob = blob
        self.remaining = total
        self.off = start % len(blob)

    async def read(self, n: int = -1) -> bytes:
        mem = bytearray(min(n if n >= 0 else 1 << 20, self.remaining))
        return bytes(mem[:await self.readinto(memoryview(mem))])

    async def readinto(self, mem) -> int:
        n = min(len(mem), self.remaining, len(self.blob) - self.off)
        mem[:n] = self.blob[self.off:self.off + n]
        self.off = (self.off + n) % len(self.blob)
        self.remaining -= n
        return n


def source_bytes(blob: memoryview, lo: int, n: int) -> bytes:
    """Bytes ``[lo, lo + n)`` of the cyclic stream over ``blob``."""
    out = bytearray()
    while n > 0:
        off = lo % len(blob)
        take = min(n, len(blob) - off)
        out += blob[off:off + take]
        lo += take
        n -= take
    return bytes(out)


def make_blob(torch, device, seed: int, nbytes: int) -> memoryview:
    """``nbytes`` random bytes from the seed, drawn on the device in one
    call and brought to the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    data = torch.randint(0, 256, (nbytes,), dtype=torch.uint8,
                         device=device, generator=gen)
    return memoryview(data.cpu().numpy()).cast("B")


def build_cluster(config: dict, root: str, backend: str):
    """The configuration's cluster over ``destinations`` directories under
    ``root``, with its metadata store beside them."""
    from chunky_bits_tpu_torch.cluster.cluster import Cluster
    from chunky_bits_tpu_torch.ops.backend import get_backend

    dirs = [os.path.join(root, f"d{i:02d}")
            for i in range(config["destinations"])]
    meta = os.path.join(root, "meta")
    for d in dirs + [meta]:
        os.makedirs(d)
    cluster = Cluster.from_obj({
        "destinations": [{"location": d} for d in dirs],
        "metadata": dict(config["metadata"], path=meta),
        "profiles": {"default": {"data": config["data"],
                                 "parity": config["parity"],
                                 "chunk_size": config["chunk_size_log2"]}},
        "tunables": {"backend": backend,
                     "cache_bytes": config["cache_bytes"]},
    })
    be = get_backend(backend)
    if hasattr(be, "device_sha"):
        be.device_sha = bool(config["device_sha"])
    return cluster


class Context:
    def __init__(self, run: Run, cluster, blob: memoryview, seed: int,
                 spans: Spans):
        self.run = run
        self.cluster = cluster
        self.profile = cluster.get_profile()
        self.blob = blob
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.spans = spans


class Window:
    """The measured window on the host's monotonic clock: open at
    ``t_start`` for ``seconds``; until it opens both ends lie in the
    future, so the closed loops run on through their warm-up."""

    def __init__(self) -> None:
        self.t_start = float("inf")
        self.t_end = float("inf")

    def open(self, seconds: float) -> None:
        self.t_start = time.monotonic()
        self.t_end = self.t_start + seconds

    def count(self, t: float, nbytes: int) -> int:
        """``nbytes`` if ``t`` lies inside the window, else 0."""
        return nbytes if self.t_start <= t <= self.t_end else 0


class ClosedLoop:
    """``clients`` loops, each sending its next request when the last is
    answered, from the warm-up through the window without a pause, so at
    the window's edges every client is at its own point of a request.
    ``warm`` is set once ``warmup`` requests a client have been
    answered."""

    def __init__(self, clients: int, warmup: int):
        self.clients = clients
        self.need = clients * warmup
        self.done = 0
        self.warm = asyncio.Event()

    async def run(self, win: Window, step) -> None:
        async def client(c: int) -> None:
            j = 0
            while time.monotonic() < win.t_end:
                await step(c, j)
                j += 1
                self.done += 1
                if self.done >= self.need:
                    self.warm.set()

        await asyncio.gather(*(client(c) for c in range(self.clients)))


def operation(op: str, root: Optional[str] = None):
    """The ``Traffic`` class of ``gpubench/traffic/<op>.py``."""
    base = os.path.join(root, "gpubench") if root else HERE
    path = os.path.join(base, "traffic", op + ".py")
    spec = importlib.util.spec_from_file_location(
        "gpubench_traffic_" + re.sub(r"\W", "_", op), path)
    if spec is None or spec.loader is None or not os.path.isfile(path):
        raise KeyError(f"no traffic operation {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.Traffic


def record_launches(launches: dict) -> None:
    """Note the shape of every kernel launch the window makes: K1's
    ``(n, k, r, s)`` and the SHA kernel's ``(rows, s)``, with the host
    time of the call.  Traced runs only."""
    from chunky_bits_tpu_torch.ops import gf_kernel, sha256

    apply_matrix, sha256_parts = gf_kernel.apply_matrix, sha256.sha256_parts
    launches.setdefault("gf_apply", [])
    launches.setdefault("sha256_rows", [])

    def recorded_apply(table, shards):
        out = apply_matrix(table, shards)
        if shards.device.type == "cuda":
            n, k, s = shards.shape
            launches["gf_apply"].append(
                (time.monotonic(), n, k, table.shape[0], s))
        return out

    def recorded_sha(a, b=None):
        out = sha256_parts(a, b)
        if a.device.type == "cuda":
            rows = a.shape[0] * (a.shape[1] + (0 if b is None
                                               else b.shape[1]))
            launches["sha256_rows"].append((time.monotonic(), rows,
                                            a.shape[2]))
        return out

    gf_kernel.apply_matrix = recorded_apply
    sha256.sha256_parts = recorded_sha


def pipeline_stages(cluster) -> dict:
    st = cluster.host_pipeline().stats()
    return {s.stage: [s.jobs, round(s.busy_s, 3)] for s in st.stages}


def pipeline_cpu(cluster) -> dict:
    """The cluster's host pipeline (the one its reads and writes run
    on): the CPU seconds its worker threads have used, and their number.
    Jobs that run inline on a caller's thread are not the workers'."""
    pipe = cluster.host_pipeline()
    workers = [t for t in getattr(pipe, "_workers", ()) if t.is_alive()]
    cpu = 0.0
    for t in workers:
        try:
            cpu += time.clock_gettime(time.pthread_getcpuclockid(t.ident))
        except (OSError, AttributeError):
            return {}
    return {"host.worker_cpu_s": cpu, "host.threads": len(workers)}


def run_cell(workload: str, config: dict, traffic: dict, seed: int,
             seconds: float, trace: bool, t_process: float,
             backend: Optional[str] = None, device: str = "cuda",
             fault: Optional[str] = None, root: Optional[str] = None
             ) -> tuple[Run, dict, dict]:
    """One run of a cell: returns the run, the numbers compared (name:
    (value, limit)) and what the device reported."""
    import torch

    dev = torch.device(device)
    random.seed(seed)
    run = Run(workload, config, traffic)
    spans = Spans(trace)
    blob = make_blob(torch, dev, seed, int(traffic["blob_bytes"]))
    if dev.type == "cuda":
        # the blob's device copy is the harness's, not the program's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    store = tempfile.mkdtemp(prefix="gpubench-")
    try:
        cluster = build_cluster(config, store, backend or config["backend"])
        ctx = Context(run, cluster, blob, seed, spans)
        gen = operation(traffic["op"], root)(ctx)
        tracer = None
        if trace and dev.type == "cuda":
            from gpubench.trace import DeviceTrace

            tracer = DeviceTrace(torch, dev)

        async def drive() -> None:
            win = Window()
            try:
                await gen.prepare()
                work = asyncio.ensure_future(gen.run(win, run.ops))
                warm = asyncio.ensure_future(gen.loop.warm.wait())
                await asyncio.wait([work, warm],
                                   return_when=asyncio.FIRST_COMPLETED)
                if work.done():
                    warm.cancel()
                    await work  # raises what stopped the loop
                c0 = dict(gen.counters(), **pipeline_cpu(cluster))
                c0["loop.cpu_s"] = time.thread_time()
                s0 = pipeline_stages(cluster)
                r0 = resource.getrusage(resource.RUSAGE_SELF)
                if trace:
                    record_launches(run.launches)
                if tracer is not None:
                    tracer.start()
                undo = faults.install(fault)
                win.open(seconds)
                run.t_start = win.t_start
                run.setup_s = run.t_start - t_process
                await asyncio.wait(
                    [work], timeout=max(0.0, win.t_end - time.monotonic()))
                run.t_end = time.monotonic()
                c1 = dict(gen.counters(), **pipeline_cpu(cluster))
                c1["loop.cpu_s"] = time.thread_time()
                s1 = pipeline_stages(cluster)
                r1 = resource.getrusage(resource.RUSAGE_SELF)
                run.notes["stages"] = {
                    k: [v[0] - s0.get(k, [0, 0])[0],
                        round(v[1] - s0.get(k, [0, 0])[1], 3)]
                    for k, v in s1.items()}
                run.notes["cpu_s"] = [round(r1.ru_utime - r0.ru_utime, 3),
                                      round(r1.ru_stime - r0.ru_stime, 3)]
                if tracer is not None:
                    tracer.stop()
                await asyncio.wait_for(work, DRAIN_S)
                undo()
                run.counters = {k: c1[k] - c0.get(k, 0) for k in c1}
                if "host.threads" in c1:
                    run.counters["host.threads"] = c1["host.threads"]
            finally:
                await gen.close()

        asyncio.run(drive())
        run.launches = {name: [x[1:] for x in rows
                               if run.t_start <= x[0] <= run.t_end]
                        for name, rows in run.launches.items()}
        dev_info = {"count": 1}
        if dev.type == "cuda":
            dev_info.update(platform="gpu",
                            kind=torch.cuda.get_device_name(dev),
                            memory_peak_bytes=int(
                                torch.cuda.max_memory_allocated(dev)))
        else:
            dev_info.update(platform="cpu", kind="cpu", memory_peak_bytes=0)
        if tracer is not None:
            run.trace = tracer.summary(run.t_start, run.t_end, spans.items)
        checked = gen.check(run)
        return run, checked, dev_info
    finally:
        shutil.rmtree(store, ignore_errors=True)
