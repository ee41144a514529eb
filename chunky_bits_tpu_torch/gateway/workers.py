"""Multi-worker serving plane: N pre-forked SO_REUSEPORT gateway
processes under one supervisor (the port of
``chunky_bits_tpu_torch/gateway/workers.py``).

The reference serves a whole cluster through one process
(src/http.rs + main.rs:474-485).  ``serve(..., workers=N)`` spawns N
worker processes, each binding the same (host, port) with
``SO_REUSEPORT`` so the kernel balances accepted connections across
them: no userspace proxy, no shared accept lock, and a worker crash never
wedges the listener (the others keep accepting while the supervisor
respawns the dead slot with capped backoff).

Each worker builds its own ``Cluster`` from the same spec, and with it
its own event loop, host pipeline, chunk cache (loop-bound; the fleet
may hold up to ``workers * cache_bytes`` of cached chunks), health
scoreboard, and on a ``cuda`` cluster its own CUDA context and kernel
load.

The supervisor holds a bound but never listening ``SO_REUSEPORT``
placeholder socket for the port's lifetime: it pins the port
(``--listen-addr host:0`` works; workers are told the resolved port)
and keeps the address across the respawn gap.  TCP lookup only considers
listening sockets, so the placeholder never takes a connection.

Worker handshake: each child prints ``CHUNKY_BITS_TORCH_GATEWAY_READY``
on stdout once its listener accepts, and the supervisor waits (bounded) for
every slot before declaring the gateway up.  The worker count comes from
``http-gateway --workers`` > ``$CHUNKY_BITS_TORCH_GATEWAY_WORKERS``
(``tunables.gateway_workers``) > 1.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import shutil
import signal
import socket
import sys
import tempfile
import time
from typing import Callable, Optional

from chunky_bits_tpu_torch.errors import ChunkyBitsError
from chunky_bits_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("chunky_bits_tpu_torch.gateway.workers")

#: stdout line a worker prints once its SO_REUSEPORT listener accepts
READY_MARKER = "CHUNKY_BITS_TORCH_GATEWAY_READY"

#: respawn backoff: first retry fast, then exponential up to the cap —
#: a crash-looping worker must not melt the box, a one-off crash must
#: not leave the slot dark for long
_BACKOFF_INITIAL = 0.5
_BACKOFF_CAP = 10.0
#: a worker that survived this long resets its slot's backoff
_BACKOFF_RESET_UPTIME = 30.0

#: seconds a SIGTERM'd worker keeps its listener up while /healthz
#: answers 503 draining (in-flight requests finish; balancers observe
#: the drain) before serve is cancelled — well under the supervisor's
#: 5 s SIGKILL escalation
_DRAIN_SECONDS = 0.5


def _reuse_port_supported() -> bool:
    return hasattr(socket, "SO_REUSEPORT")


class GatewaySupervisor:
    """Owns the worker fleet for one (cluster, host, port) gateway:
    spawn, readiness, respawn-on-death, graceful stop.  All bookkeeping
    runs on the creating loop."""

    def __init__(self, cluster_obj: dict, host: str, port: int,
                 workers: int, serve_params: Optional[dict] = None,
                 ready_timeout: float = 60.0):
        if workers < 1:
            raise ChunkyBitsError(f"workers must be >= 1, got {workers}")
        if not _reuse_port_supported():
            raise ChunkyBitsError(
                "multi-worker gateway needs SO_REUSEPORT "
                "(unsupported on this platform); run with --workers 1")
        self.cluster_obj = cluster_obj
        self.host = host
        self.port = port  # resolved (non-zero) after start()
        self.workers = workers
        self.serve_params = dict(serve_params or {})
        self.ready_timeout = ready_timeout
        self._placeholder: Optional[socket.socket] = None
        self._spec_path: Optional[str] = None
        #: fleet metrics spool: every worker publishes its registry
        #: snapshot here (obs/metrics.py) so ANY worker's /metrics can
        #: serve the aggregated fleet view; created at start, removed
        #: at stop
        self.metrics_spool: Optional[str] = None
        self._procs: list = [None] * workers
        self._ready: list = [False] * workers
        self._slot_tasks: list = []
        self._drain_tasks: dict = {}
        self._stopping = False

    # ---- lifecycle ----

    async def start(self) -> None:
        """Reserve the port, write the worker spec, spawn every slot,
        and wait (bounded) until all workers accept connections.  Raises
        on a fleet that never comes up — a half-dead start must fail
        loudly, not serve at reduced capacity silently."""
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            sock.bind((self.host, self.port))
        except BaseException as err:
            # close on ANY setup failure (setsockopt included), not
            # just the bind OSError the old shape guarded
            sock.close()
            if isinstance(err, OSError):
                raise ChunkyBitsError(
                    f"cannot bind {self.host}:{self.port}: {err}"
                ) from err
            raise
        self._placeholder = sock
        self.port = sock.getsockname()[1]
        self.metrics_spool = await asyncio.to_thread(
            tempfile.mkdtemp, prefix="cb-gateway-metrics-")
        self.serve_params.setdefault("metrics_spool",
                                     self.metrics_spool)
        self._spec_path = await asyncio.to_thread(self._write_spec)
        self._slot_tasks = [
            asyncio.ensure_future(self._run_slot(i))
            for i in range(self.workers)
        ]
        deadline = time.monotonic() + self.ready_timeout
        while not all(self._ready):
            if time.monotonic() > deadline:
                await self.stop()
                raise ChunkyBitsError(
                    f"gateway workers not ready after "
                    f"{self.ready_timeout:g}s "
                    f"({sum(self._ready)}/{self.workers} up)")
            dead = [t for t in self._slot_tasks if t.done()]
            for t in dead:
                # a slot task can only finish this early by crashing;
                # surface its exception instead of timing out blind
                if t.exception() is not None:
                    await self.stop()
                    raise ChunkyBitsError(
                        "gateway worker slot failed during start"
                    ) from t.exception()
            await asyncio.sleep(0.05)

    def worker_pids(self) -> list:
        """PIDs of the currently-live workers (respawns change them —
        the respawn test keys off exactly that)."""
        return [p.pid for p in self._procs
                if p is not None and p.returncode is None]

    def fleet_snapshot(self) -> dict:
        """The aggregated fleet metrics snapshot straight off the
        spool (counters/histograms summed, gauges worker-labeled) —
        the supervisor-side twin of any worker's ``GET /metrics``, for
        tooling that has the supervisor but not a socket.  Blocking
        file reads (small JSON files); call off-loop from async code.
        Empty until the first worker heartbeat (~2 s after ready)."""
        if self.metrics_spool is None:
            return {"families": []}
        return obs_metrics.fleet_snapshot(self.metrics_spool)

    async def wait(self) -> None:
        """Run until cancelled (the serve loop's park)."""
        while not self._stopping:
            await asyncio.sleep(3600)

    async def stop(self) -> None:
        """Terminate the fleet: SIGTERM, bounded wait, SIGKILL
        stragglers; release the placeholder and the spec file.
        Idempotent."""
        self._stopping = True
        for t in self._slot_tasks:
            t.cancel()
        for t in self._drain_tasks.values():
            t.cancel()
        if self._slot_tasks or self._drain_tasks:
            await asyncio.gather(*self._slot_tasks,
                                 *self._drain_tasks.values(),
                                 return_exceptions=True)
        self._slot_tasks = []
        self._drain_tasks = {}
        for proc in self._procs:
            if proc is None or proc.returncode is not None:
                continue
            try:
                proc.terminate()
            except ProcessLookupError:
                continue
        for proc in self._procs:
            if proc is None or proc.returncode is not None:
                continue
            try:
                await asyncio.wait_for(proc.wait(), timeout=5.0)
            except asyncio.TimeoutError:
                proc.kill()
                try:
                    await asyncio.wait_for(proc.wait(), timeout=5.0)
                except asyncio.TimeoutError:
                    # degrade, never hang: an unkillable (D-state) child
                    # is the kernel's problem, not the shutdown path's
                    log.error("gateway worker pid %d ignored SIGKILL",
                              proc.pid)
        if self._placeholder is not None:
            self._placeholder.close()
            self._placeholder = None
        if self._spec_path is not None:
            path = self._spec_path
            self._spec_path = None
            await asyncio.to_thread(self._unlink_quiet, path)
        if self.metrics_spool is not None:
            spool = self.metrics_spool
            self.metrics_spool = None
            await asyncio.to_thread(shutil.rmtree, spool, True)

    # ---- internals ----

    @staticmethod
    def _unlink_quiet(path: str) -> None:
        try:
            os.unlink(path)
        except OSError:
            pass

    def _write_spec(self) -> str:
        """The worker spec file: cluster definition + serve parameters,
        JSON (``Cluster.to_obj`` round-trips through plain types).  One
        file serves every (re)spawn; removed at stop."""
        fd, path = tempfile.mkstemp(prefix="cb-gateway-",
                                    suffix=".json")
        with os.fdopen(fd, "w") as f:
            json.dump({
                "cluster": self.cluster_obj,
                "host": self.host,
                "port": self.port,
                "serve": self.serve_params,
            }, f)
        return path

    def _child_env(self) -> dict:
        """Child env: inherited, plus the package root on PYTHONPATH so
        ``-m chunky_bits_tpu_torch.gateway.workers`` resolves however
        the parent imported the package."""
        import chunky_bits_tpu_torch
        from chunky_bits_tpu_torch.cluster.tunables import environ_without

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(chunky_bits_tpu_torch.__file__)))
        env = environ_without()
        prior = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = (pkg_root + os.pathsep + prior
                             if prior else pkg_root)
        return env

    async def _run_slot(self, i: int) -> None:
        """One worker slot: spawn, wait for readiness, watch for death,
        respawn with capped backoff.  The slot never gives up while the
        supervisor lives — with other workers healthy the listener
        stays responsive through any one slot's crash loop."""
        backoff = _BACKOFF_INITIAL
        while not self._stopping:
            spawned_at = time.monotonic()
            try:
                proc = await asyncio.create_subprocess_exec(
                    sys.executable, "-m",
                    "chunky_bits_tpu_torch.gateway.workers", self._spec_path,
                    stdout=asyncio.subprocess.PIPE,
                    env=self._child_env())
            except OSError as err:
                log.error("gateway worker %d spawn failed: %s", i, err)
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, _BACKOFF_CAP)
                continue
            self._procs[i] = proc
            ok = await self._await_ready(proc)
            if ok:
                self._ready[i] = True
                drain = asyncio.ensure_future(self._drain(proc))
                self._drain_tasks[proc.pid] = drain
            else:
                log.error("gateway worker %d (pid %d) never reported "
                          "ready", i, proc.pid)
                try:
                    proc.terminate()
                except ProcessLookupError:
                    pass
            rc = await self._wait_exit(proc)
            self._drain_tasks.pop(proc.pid, None)
            # reap the dead worker's spool snapshot: the fleet /metrics
            # view must report who is ALIVE — a crashed worker's frozen
            # gauges (in-flight counts, worker_up) must not haunt every
            # scrape until supervisor stop.  Its counters drop out of
            # the fleet totals, which Prometheus-style consumers treat
            # as an ordinary counter reset.
            if self.metrics_spool is not None:
                await asyncio.to_thread(
                    self._unlink_quiet,
                    os.path.join(self.metrics_spool,
                                 f"worker-{proc.pid}.json"))
            if self._stopping:
                return
            uptime = time.monotonic() - spawned_at
            if uptime >= _BACKOFF_RESET_UPTIME:
                backoff = _BACKOFF_INITIAL
            log.warning("gateway worker %d (pid %d) exited rc=%s after "
                        "%.1fs; respawning in %.1fs", i, proc.pid, rc,
                        uptime, backoff)
            await asyncio.sleep(backoff)
            backoff = min(backoff * 2, _BACKOFF_CAP)

    async def _await_ready(self, proc) -> bool:
        """Bounded readiness handshake: scan the child's stdout for the
        READY marker.  False on exit/EOF/timeout."""
        deadline = time.monotonic() + self.ready_timeout
        while time.monotonic() < deadline:
            try:
                line = await asyncio.wait_for(proc.stdout.readline(),
                                              timeout=1.0)
            except asyncio.TimeoutError:
                if proc.returncode is not None:
                    return False
                continue
            if not line:
                return False
            if line.decode(errors="replace").startswith(READY_MARKER):
                return True
        return False

    async def _drain(self, proc) -> None:
        """Keep the child's stdout pipe from filling after readiness;
        post-READY chatter is relayed to the supervisor log."""
        while True:
            try:
                line = await asyncio.wait_for(proc.stdout.readline(),
                                              timeout=60.0)
            except asyncio.TimeoutError:
                continue
            if not line:
                return
            log.debug("worker pid %d: %s", proc.pid,
                      line.decode(errors="replace").rstrip())

    async def _wait_exit(self, proc) -> Optional[int]:
        """Bounded-poll wait for a worker's exit; returns its exit
        code."""
        while True:
            try:
                return await asyncio.wait_for(proc.wait(), timeout=5.0)
            except asyncio.TimeoutError:
                if self._stopping:
                    return proc.returncode
                continue


async def serve_workers(cluster, host: str, port: int, workers: int,
                        on_ready: Optional[Callable[[int], None]] = None,
                        **serve_params) -> None:
    """The ``serve(..., workers=N>1)`` body: run a supervisor until
    cancelled (ctrl-c), then tear the fleet down."""
    sup = GatewaySupervisor(cluster.to_obj(), host, port, workers,
                            serve_params=serve_params)
    await sup.start()
    print(f"listening on http://{host}:{sup.port} "
          f"({workers} workers)", flush=True)
    if on_ready is not None:
        on_ready(sup.port)
    try:
        # the serve park (a bounded-sleep loop); ctrl-c cancels it
        # lint: unbounded-await-ok the serve park itself (internally a
        # bounded-sleep loop); resolves on ctrl-c cancellation exactly
        # like single-process serve's sleep loop
        await sup.wait()
    # ctrl-c or cancel is the shutdown signal: the finally tears the
    # fleet down before exit
    # lint: cancel-safety-ok ctrl-c/cancel IS the shutdown signal for
    # the supervisor park; swallowing it hands control to the finally's
    # graceful fleet teardown (sup.stop) before exit
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await sup.stop()


# ---- worker child entry (`python -m chunky_bits_tpu_torch.gateway.workers`) ----


async def _worker_amain(spec: dict) -> None:
    from chunky_bits_tpu_torch.cluster import Cluster
    from chunky_bits_tpu_torch.gateway.http import HealthState, serve

    cluster = Cluster.from_obj(spec["cluster"])
    loop = asyncio.get_running_loop()
    stop = asyncio.Event()
    health_state = HealthState()

    def request_stop() -> None:
        # flip /healthz to draining FIRST: a balancer polling it stops
        # routing before the listener actually goes away
        health_state.draining = True
        stop.set()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, request_stop)
        except (NotImplementedError, RuntimeError):
            pass  # non-unix / nested-loop harnesses: supervisor kills

    def announce(bound_port: int) -> None:
        print(f"{READY_MARKER} port={bound_port} pid={os.getpid()}",
              flush=True)

    # cancelled and awaited in the finally below
    # lint: task-custody-ok cancelled-and-awaited in the finally below;
    # the only statement before the try is ensure_future(stop.wait()),
    # which cannot raise
    serve_task = asyncio.ensure_future(serve(
        cluster, host=spec["host"], port=spec["port"], workers=1,
        reuse_port=True, on_ready=announce,
        health_state=health_state, **spec.get("serve", {})))
    stop_task = asyncio.ensure_future(stop.wait())
    try:
        # the worker's lifetime is the service's: this resolves on
        # SIGTERM (stop_task) or a serve crash (serve_task), and the
        # supervisor escalates to SIGKILL
        # lint: unbounded-await-ok the worker's lifetime IS the service
        # lifetime: this resolves on SIGTERM (stop_task) or a serve
        # crash (serve_task), and the supervisor escalates to SIGKILL
        await asyncio.wait({serve_task, stop_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if stop.is_set() and not serve_task.done():
            # drain window: /healthz already answers 503 draining —
            # give in-flight requests (and one balancer poll) a beat
            # before the listener is torn down
            # lint: unbounded-await-ok bounded by timeout=_DRAIN_SECONDS
            # (0.5 s), well under the supervisor's SIGKILL escalation
            await asyncio.wait({serve_task}, timeout=_DRAIN_SECONDS)
    finally:
        serve_task.cancel()
        stop_task.cancel()
        await asyncio.gather(serve_task, stop_task,
                             return_exceptions=True)
        await cluster.tunables.location_context().aclose()
    # surface a serve crash as a nonzero exit so the supervisor logs it
    if serve_task.cancelled():
        return
    err = serve_task.exception()
    if err is not None:
        raise err


def worker_main(argv: Optional[list] = None) -> int:
    """Child entry: load the spec, build this worker's own Cluster
    (its own cache, health, pipeline and CUDA context; see the module
    docstring), and serve single-process with ``reuse_port=True``."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m chunky_bits_tpu_torch.gateway.workers "
              "<spec.json>", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr)
    with open(argv[0]) as f:
        spec = json.load(f)
    try:
        asyncio.run(_worker_amain(spec))
    except KeyboardInterrupt:
        return 0
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
