"""Opt-in runtime concurrency sanitizer for the two-plane runtime.

The CB2xx rules prove hazards statically where the call graph can see
them; this module catches the dynamic remainder at runtime, enabled by
``$CHUNKY_BITS_TORCH_SANITIZE`` (via ``tunables.sanitize_enabled`` —
CB102) and OFF by default.  Three monitors, all built never to hang:

* :class:`LoopWatchdog` — a daemon sampling thread heartbeats every
  registered event loop through ``call_soon_threadsafe`` and records a
  *stall* when a running loop fails to service the heartbeat within the
  threshold (a blocked loop = CB201's hazard actually happening).  It
  never blocks on a loop: a dead loop (stopped but not closed) simply
  never completes a heartbeat and records nothing; a closed loop is
  dropped on the ``RuntimeError``.
* :class:`TaskRegistry` — a task factory + loop exception handler pair
  that records every spawned task's creation site and captures the
  "Task was destroyed but it is pending!" / "exception was never
  retrieved" events the stock loop only logs (CB203's hazard at
  runtime).  ``pending_leaks()`` additionally reports live, unfinished
  tasks whose loop already stopped — the leak tier-1's leak-strict mode
  could not previously see.
* :class:`HandoffChecker` — asserts HostPipeline completions land on
  the submitting side: the submit records (loop, thread), the bridge
  callback's resolve verifies it is running on that same loop+thread
  (CB204's contract), and a blocking job wait issued *from* a loop
  thread is recorded as a violation (the sync-wait-on-loop deadlock
  shape).

Activation: :func:`install` swaps in an event-loop policy that
instruments every future loop (and can instrument an existing one via
:meth:`Sanitizer.instrument_loop`); ``HostPipeline`` and the gateway
self-activate when the flag is set, and ``sim.run`` instruments its
virtual-time loop when a sanitizer is active.  The hot-path hooks in
``parallel/host_pipeline.py`` reach this module only through
``sys.modules`` — when the sanitizer was never imported, the off path
costs a dict lookup and imports nothing (pinned by
tests/test_torch_sanitizer.py).
"""

from __future__ import annotations

import asyncio
import threading
import time
import traceback
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

__all__ = [
    "HandoffChecker",
    "LoopWatchdog",
    "Sanitizer",
    "SanitizerReport",
    "TaskRegistry",
    "active",
    "get_monitor",
    "install",
    "report",
    "uninstall",
]


@dataclass
class SanitizerReport:
    """Aggregate findings at report time.  ``stalls`` are advisory
    (CI boxes stall under load); the other three are hard failures for
    the tier-1 sanitize leg."""

    leaked_tasks: list[str] = field(default_factory=list)
    unretrieved_exceptions: list[str] = field(default_factory=list)
    handoff_violations: list[str] = field(default_factory=list)
    stalls: list[str] = field(default_factory=list)

    def ok(self) -> bool:
        return not (self.leaked_tasks or self.unretrieved_exceptions
                    or self.handoff_violations)

    def render(self) -> str:
        lines = [
            f"sanitizer: {len(self.leaked_tasks)} leaked task(s), "
            f"{len(self.unretrieved_exceptions)} unretrieved "
            f"exception(s), {len(self.handoff_violations)} handoff "
            f"violation(s), {len(self.stalls)} loop stall(s) [advisory]"
        ]
        for tag, items in (("LEAKED", self.leaked_tasks),
                           ("UNRETRIEVED", self.unretrieved_exceptions),
                           ("HANDOFF", self.handoff_violations),
                           ("STALL", self.stalls)):
            lines.extend(f"  {tag}: {item}" for item in items)
        return "\n".join(lines)


def _creation_site() -> str:
    """First stack frame outside asyncio/this module — where the task
    was actually spawned."""
    for frame in reversed(traceback.extract_stack(limit=12)):
        fn = frame.filename
        if "asyncio" in fn or fn.endswith("sanitizer.py"):
            continue
        return f"{fn}:{frame.lineno} ({frame.name})"
    return "<unknown>"


class TaskRegistry:
    """Per-process task bookkeeping: creation sites via a task factory,
    lifecycle failures via the loop exception handler."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: weakref(task) -> creation site; the weakref callback removes
        #: its own entry so the registry never pins a task
        self._tasks: dict[weakref.ref, str] = {}
        self._events: list[str] = []

    # ---- loop instrumentation ----

    def install_on_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        loop.set_task_factory(self._factory)
        prev = loop.get_exception_handler()

        def handler(lp: asyncio.AbstractEventLoop,
                    context: dict) -> None:
            self._on_exception(lp, context, prev)

        loop.set_exception_handler(handler)

    def _factory(self, loop: asyncio.AbstractEventLoop, coro: Any,
                 **kwargs: Any) -> asyncio.Task:
        # mirror the stock factory (3.10 calls factory(loop, coro);
        # newer versions add context=) — never alter task semantics
        task = asyncio.Task(coro, loop=loop, **kwargs)
        site = _creation_site()
        with self._lock:
            ref = weakref.ref(task, self._drop)
            self._tasks[ref] = site
        return task

    def _drop(self, ref: weakref.ref) -> None:
        # deliberately lock-free: this runs as a weakref callback,
        # which cyclic GC may fire re-entrantly INSIDE one of this
        # class's locked sections on the same thread — taking the
        # non-reentrant lock there would deadlock the loop thread.
        # A single dict pop is GIL-atomic.
        self._tasks.pop(ref, None)

    def _on_exception(self, loop: asyncio.AbstractEventLoop,
                      context: dict, prev: Any) -> None:
        msg = str(context.get("message", ""))
        captured = ("never retrieved" in msg
                    or "destroyed but it is pending" in msg)
        if captured:
            task = context.get("task") or context.get("future")
            exc = context.get("exception")
            detail = f"{msg}: {task!r}"
            if exc is not None:
                detail += f" exception={exc!r}"
            with self._lock:
                self._events.append(detail)
            # the sanitizer owns reporting for captured events; the
            # default handler would only duplicate them on stderr
            return
        if prev is not None:
            prev(loop, context)
        else:
            loop.default_exception_handler(context)

    # ---- reporting ----

    def events(self) -> list[str]:
        with self._lock:
            return list(self._events)

    def pending_leaks(self) -> list[str]:
        """Live, unfinished tasks whose loop already stopped running —
        nobody can ever await them now."""
        # bounded retry: _drop is lock-free (see above), so a GC pop
        # can race this snapshot and raise "changed size during
        # iteration"
        for _ in range(8):
            try:
                with self._lock:
                    snapshot = list(self._tasks.items())
                break
            except RuntimeError:
                continue
        else:
            snapshot = []
        out = []
        for ref, site in snapshot:
            task = ref()
            if task is None or task.done():
                continue
            loop = task.get_loop()
            if loop.is_closed() or not loop.is_running():
                out.append(f"{task!r} created at {site}")
        return out


class LoopWatchdog:
    """Heartbeat-samples registered loops from a daemon thread and
    records stalls.  Every wait in here is bounded; the thread holds no
    loop resources, so a hung or dead loop can never hang the watchdog
    (or vice versa)."""

    def __init__(self, threshold: float = 1.0,
                 interval: float = 0.25) -> None:
        self.threshold = threshold
        self.interval = interval
        self._lock = threading.Lock()
        #: id(loop) -> (weakref, sent_at, done_flag, reported)
        self._beats: dict[int, list] = {}
        self.stalls: list[str] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def watch(self, loop: asyncio.AbstractEventLoop) -> None:
        with self._lock:
            self._beats.setdefault(
                id(loop), [weakref.ref(loop), None, None, False])
        self._ensure_thread()

    def _ensure_thread(self) -> None:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="cb-sanitizer-wd")
            self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            with self._lock:
                entries = list(self._beats.items())
            for key, entry in entries:
                ref, sent_at, done, reported = entry
                loop = ref()
                if loop is None or loop.is_closed():
                    with self._lock:
                        self._beats.pop(key, None)
                    continue
                now = time.monotonic()
                if sent_at is not None and not done[0]:
                    # only a RUNNING loop that ignores its heartbeat is
                    # stalled; a stopped-but-open loop just idles here
                    if (now - sent_at > self.threshold
                            and loop.is_running() and not reported):
                        entry[3] = True
                        with self._lock:
                            self.stalls.append(
                                f"loop {key:#x} unresponsive for "
                                f">{self.threshold:.2f}s (callback "
                                "blocking the event loop?)")
                    continue
                flag = [False]
                try:
                    loop.call_soon_threadsafe(
                        flag.__setitem__, 0, True)
                except RuntimeError:
                    # closed between the check and the call: drop it
                    with self._lock:
                        self._beats.pop(key, None)
                    continue
                entry[1] = now
                entry[2] = flag
                entry[3] = False

    def stop(self, timeout: float = 2.0) -> None:
        self._stop.set()
        thread = self._thread
        if thread is not None:
            thread.join(timeout)


class HandoffChecker:
    """Asserts host-pipeline completions land on the submitting side
    and that no loop thread sits in a blocking job wait."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.violations: list[str] = []
        #: submits recorded and completions checked: proof that the
        #: pipeline's hooks fired in a sanitized run
        self.submits = 0
        self.resolves = 0

    def _record(self, message: str) -> None:
        with self._lock:
            self.violations.append(message)

    def submit_token(self) -> tuple:
        token = (asyncio.get_running_loop(), threading.get_ident())
        with self._lock:
            self.submits += 1
        return token

    def check_resolve(self, token: tuple) -> None:
        with self._lock:
            self.resolves += 1
        loop, tid = token
        try:
            running = asyncio.get_running_loop()
        except RuntimeError:
            running = None
        if running is not loop or threading.get_ident() != tid:
            rid = id(running) if running is not None else 0
            self._record(
                "pipeline completion resolved off the submitting "
                f"side: submitted on loop {id(loop):#x} (thread "
                f"{tid}), resolved on loop {rid:#x} (thread "
                f"{threading.get_ident()})")

    def check_sync_wait(self, where: str) -> None:
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return
        self._record(
            f"blocking {where} on an event-loop thread: the loop "
            "stalls until a worker finishes — await the async API "
            "instead")


class Sanitizer:
    """One installed sanitizer: registry + watchdog + handoff checker
    plus the loop-policy shim that instruments future loops."""

    def __init__(self, watchdog_threshold: float = 1.0) -> None:
        self.tasks = TaskRegistry()
        self.watchdog = LoopWatchdog(threshold=watchdog_threshold)
        self.handoff = HandoffChecker()
        self._prev_policy: Optional[asyncio.AbstractEventLoopPolicy] \
            = None

    def instrument_loop(self, loop: asyncio.AbstractEventLoop) -> None:
        self.tasks.install_on_loop(loop)
        self.watchdog.watch(loop)

    def _install_policy(self) -> None:
        prev = asyncio.get_event_loop_policy()
        sanitizer = self

        class _SanitizingPolicy(type(prev)):  # type: ignore[misc]
            def new_event_loop(self) -> asyncio.AbstractEventLoop:
                loop = super().new_event_loop()
                sanitizer.instrument_loop(loop)
                return loop

        self._prev_policy = prev
        asyncio.set_event_loop_policy(_SanitizingPolicy())

    def close(self) -> None:
        self.watchdog.stop()
        if self._prev_policy is not None:
            asyncio.set_event_loop_policy(self._prev_policy)
            self._prev_policy = None

    def report(self) -> SanitizerReport:
        return SanitizerReport(
            leaked_tasks=self.tasks.pending_leaks(),
            unretrieved_exceptions=self.tasks.events(),
            handoff_violations=list(self.handoff.violations),
            stalls=list(self.watchdog.stalls),
        )


# ---- process-global activation ----
#
# Deliberate process-wide singleton (the sanitizer instruments global
# interpreter state — the loop policy — so two live instances would
# fight); analysis/ is outside CB205's serve-path scope, and the lock
# makes first-use construction single.

_GLOBAL: Optional[Sanitizer] = None
_GLOBAL_LOCK = threading.Lock()


def install(watchdog_threshold: float = 1.0) -> Sanitizer:
    """Install (or return) the process-global sanitizer: future event
    loops are instrumented via the policy; instrument an already-live
    loop explicitly with ``instrument_loop``."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is None:
            san = Sanitizer(watchdog_threshold=watchdog_threshold)
            san._install_policy()
            _GLOBAL = san
        return _GLOBAL


def uninstall() -> None:
    """Tear down the global sanitizer (tests): restores the previous
    loop policy and stops the watchdog thread (bounded)."""
    global _GLOBAL
    with _GLOBAL_LOCK:
        if _GLOBAL is not None:
            _GLOBAL.close()
            _GLOBAL = None


def active() -> Optional[Sanitizer]:
    """The installed sanitizer, or None.  Hot paths call this through
    ``sys.modules.get(...)`` so the off path never imports us."""
    return _GLOBAL


def get_monitor() -> Sanitizer:
    """Install-on-first-use accessor for self-activating components
    (HostPipeline, gateway serve) once ``sanitize_enabled()`` said
    yes."""
    return install()


def report() -> SanitizerReport:
    san = _GLOBAL
    return san.report() if san is not None else SanitizerReport()
