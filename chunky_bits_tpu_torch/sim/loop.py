"""Virtual-time asyncio event loop: the simulator's timebase (the port of
``chunky_bits_tpu/sim/loop.py``).

A ``SelectorEventLoop`` subclass whose ``time()`` is a virtual float that
only advances when the loop would otherwise wait: the wrapped selector
first polls the real file descriptors with timeout 0 (the self-pipe that
``call_soon_threadsafe`` writes, any real sockets a test mixes in), and
only when nothing is ready, no host-thread work is in flight, and a timer
is scheduled does it jump virtual time straight to that timer.  Every
duration, cooldown and budget accrual measured through the clock seam
(``utils/clock.py``) agrees on the same virtual timebase.

**Real work still completes.**  Thread hops (``asyncio.to_thread``,
``aio.open_in_thread``, ``loop.run_in_executor``) run on real threads;
the loop tracks them by overriding ``run_in_executor`` and refuses to
advance virtual time while any is outstanding: it blocks in a bounded real
select slice (``_REAL_WAIT_SLICE``) until the completion lands on the
self-pipe.  Thread work therefore takes zero virtual time.  A host-side
wait that does not go through ``run_in_executor`` (a future of another
executor wrapped by ``asyncio.wrap_future``, a polled CUDA event) is not
tracked, and virtual time may jump over it.

**Determinism.**  Callback order is the loop's own FIFO ready queue and
timer heap; real-time effects (thread completions) are absorbed at zero
virtual width before any timer may fire, and the default executor has one
worker, so thread hops complete in submission order.

``run()`` tears the loop down as ``asyncio.run`` does: cancel and await
every remaining task, shut down async generators and the default
executor, close the loop.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import selectors
import sys
import threading
from typing import Any, Callable, Optional

from chunky_bits_tpu_torch.utils import clock as clock_mod

__all__ = ["VirtualTimeLoop", "run"]

#: bound on one real select slice while host threads are in flight (or
#: while the loop waits on real FDs with no timer armed): completions
#: wake the loop at once through the self-pipe; the slice only caps how
#: long a stuck thread can keep the loop unresponsive to a stop request
_REAL_WAIT_SLICE = 0.2


class _VirtualSelector:
    """Selector facade that turns "would block" into virtual-time jumps.
    Wraps the loop's real selector; every method but ``select`` passes
    straight through."""

    def __init__(self, base: selectors.BaseSelector,
                 loop: "VirtualTimeLoop") -> None:
        self._base = base
        self._loop = loop

    def select(self, timeout: Optional[float] = None) -> list:
        # real readiness always wins: the self-pipe (threadsafe wakeups,
        # thread completions) and any real sockets are serviced before
        # time may move
        events = self._base.select(0)
        if events or timeout == 0:
            return events
        if self._loop._external_pending():
            # host-thread work in flight: wait for it in real time, so
            # virtual time never jumps over an unfinished disk read; the
            # completion's self-pipe write wakes the select at once
            wait = _REAL_WAIT_SLICE if timeout is None \
                else min(timeout, _REAL_WAIT_SLICE)
            return self._base.select(wait)
        if timeout is None:
            # no timers, nothing ready, no threads: the loop waits on real
            # FDs or is stuck, and only real time can resolve either; wait
            # in bounded slices so the loop stays interruptible
            return self._base.select(_REAL_WAIT_SLICE)
        # quiescent with a timer armed: jump straight to it
        self._loop._advance(timeout)
        return []

    def __getattr__(self, name: str) -> Any:
        return getattr(self._base, name)


class VirtualTimeLoop(asyncio.SelectorEventLoop):
    """The virtual-time loop; see the module docstring.  Build it through
    :func:`run` (which also installs the clock seam's ``VirtualClock``); a
    bare instance is a plain loop whose ``time()`` is virtual."""

    def __init__(self) -> None:
        super().__init__()
        self._virtual_now = 0.0
        # host-thread work in flight: incremented on the loop thread at
        # submit, decremented by the wrapped future's completion callback
        self._ext_lock = threading.Lock()
        self._ext_jobs = 0
        # one worker, FIFO: thread hops complete in submission order, so
        # their zero-width completions interleave the ready queue the same
        # way on every run.  Shut down by run()'s teardown
        self._serial_executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="cb-sim-io")
        self._selector = _VirtualSelector(self._selector, self)

    # ---- virtual time ----

    def time(self) -> float:
        return self._virtual_now

    def _advance(self, seconds: float) -> None:
        self._virtual_now += seconds

    # ---- host-thread work tracking ----

    def _external_pending(self) -> bool:
        with self._ext_lock:
            return self._ext_jobs > 0

    def _external_done(self, _fut: object) -> None:
        with self._ext_lock:
            self._ext_jobs -= 1

    def run_in_executor(self, executor: Any, func: Callable, *args: Any):
        if executor is None:
            executor = self._serial_executor
        fut = super().run_in_executor(executor, func, *args)
        with self._ext_lock:
            self._ext_jobs += 1
        # the asyncio future completes through the loop (the self-pipe
        # wakeup the selector waits for), so the decrement never lands
        # before the result is deliverable
        fut.add_done_callback(self._external_done)
        return fut


def _sanitizer():
    """The active runtime sanitizer, without importing it: the module is
    only present when ``CHUNKY_BITS_TORCH_SANITIZE`` loaded it (the same
    ``sys.modules`` door parallel/host_pipeline.py uses)."""
    mod = sys.modules.get("chunky_bits_tpu_torch.analysis.sanitizer")
    return mod.active() if mod is not None else None


def _cancel_all_tasks(loop: asyncio.AbstractEventLoop) -> None:
    """``asyncio.runners``' teardown: cancel every remaining task and run
    the loop until they finish, so nothing outlives the run."""
    to_cancel = asyncio.all_tasks(loop)
    if not to_cancel:
        return
    for task in to_cancel:
        task.cancel()
    loop.run_until_complete(
        asyncio.gather(*to_cancel, return_exceptions=True))
    for task in to_cancel:
        if task.cancelled():
            continue
        if task.exception() is not None:
            loop.call_exception_handler({
                "message": "unhandled exception during sim.run() shutdown",
                "exception": task.exception(),
                "task": task,
            })


def run(main, *, debug: Optional[bool] = None):
    """``asyncio.run`` in simulated time: run ``main`` on a fresh
    :class:`VirtualTimeLoop` with the clock seam pointing at it.

    Installs a ``VirtualClock`` bound to the loop (so every clock-seam
    read, token bucket and hold-down ticks in virtual time), restores the
    previous clock on the way out, and tears the loop down as
    ``asyncio.run`` does.  Everything time-sensitive the coroutine uses
    must be built inside it: a ``TokenBucket`` built on the real clock
    would see a huge backwards jump when virtual time starts at 0."""
    if asyncio.events._get_running_loop() is not None:
        raise RuntimeError(
            "sim.run() cannot be called from a running event loop")
    loop = VirtualTimeLoop()
    san = _sanitizer()
    if san is not None:
        # loops built by the sanitizer's policy are instrumented already;
        # this one is constructed directly, so opt in explicitly
        san.instrument_loop(loop)
    previous_clock = clock_mod.install(clock_mod.VirtualClock(loop))
    try:
        asyncio.set_event_loop(loop)
        if debug is not None:
            loop.set_debug(debug)
        return loop.run_until_complete(main)
    finally:
        # the virtual clock stays installed through teardown: cancelled
        # tasks run their cleanup on the still-virtual loop, and restoring
        # the real clock first would mix timebases
        try:
            _cancel_all_tasks(loop)
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.run_until_complete(loop.shutdown_default_executor())
        finally:
            clock_mod.install(previous_clock)
            loop._serial_executor.shutdown(wait=True)
            asyncio.set_event_loop(None)
            loop.close()
