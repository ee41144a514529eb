"""The process-wide clock seam: the port of ``chunky_bits_tpu/utils/clock.py``.

Every time-sensitive policy of the file plane (profiler I/O spans, trace
spans) reads time through :func:`monotonic` / :func:`sleep` instead of
``time.monotonic`` / ``asyncio.sleep``.  The default :class:`Clock`
delegates to the system primitives; a simulator may :func:`install` a
:class:`VirtualClock` bound to its virtual-time event loop.  The active
clock swap is one attribute rebind, and both clocks may be read from any
thread.  Stdlib only.
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

__all__ = [
    "Clock",
    "VirtualClock",
    "active",
    "install",
    "monotonic",
    "sleep",
    "system_clock",
]


class Clock:
    """The system clock: ``time.monotonic`` and ``asyncio.sleep``."""

    def monotonic(self) -> float:
        return time.monotonic()

    async def sleep(self, seconds: float) -> None:
        await asyncio.sleep(seconds)

    def call_later(self, loop: asyncio.AbstractEventLoop,
                   delay: float, callback, *args) -> asyncio.TimerHandle:
        """``loop.call_later``: a virtual loop's timers are virtual."""
        return loop.call_later(delay, callback, *args)


class VirtualClock(Clock):
    """A clock slaved to a virtual-time event loop: ``monotonic()`` is the
    loop's ``time()``, safe to read from any thread."""

    def __init__(self, loop: asyncio.AbstractEventLoop) -> None:
        self._loop = loop

    def monotonic(self) -> float:
        return self._loop.time()


_SYSTEM = Clock()
_ACTIVE: Clock = _SYSTEM


def system_clock() -> Clock:
    """The always-real system clock."""
    return _SYSTEM


def active() -> Clock:
    """The installed clock (the system clock by default)."""
    return _ACTIVE


def install(clock: Optional[Clock]) -> Clock:
    """Swap the process-wide clock and return the previous one
    (``install(None)`` restores the system clock)."""
    global _ACTIVE
    previous = _ACTIVE
    _ACTIVE = clock if clock is not None else _SYSTEM
    return previous


def monotonic() -> float:
    """Monotonic seconds on the active clock."""
    return _ACTIVE.monotonic()


async def sleep(seconds: float) -> None:
    """``asyncio.sleep`` on the active clock."""
    await _ACTIVE.sleep(seconds)
