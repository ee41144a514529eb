"""Deterministic simulation: the virtual-time event loop (the port of
``chunky_bits_tpu/sim``, so far its ``loop.py``).

``sim.run(coro)`` runs a coroutine on a :class:`VirtualTimeLoop`: when
nothing is runnable and no host-thread work is in flight, time jumps
straight to the next timer, so a 60-minute interval costs one callback of
wall time, and every duration read through the clock seam
(``utils/clock.py``) agrees on that virtual timebase.  The SLO engine, the
QoS scheduler and the token buckets run under it unchanged.

The fault-injection node plane (``sim/fabric.py``, the ``sim:`` location
scheme), the scenario engine and the crash harness of the JAX package are
not ported yet (ROADMAP Queue A item 8).  Production code paths import
nothing from this package.
"""

from chunky_bits_tpu_torch.sim.loop import VirtualTimeLoop, run  # noqa: F401

__all__ = ["VirtualTimeLoop", "run"]
