"""Deterministic cluster simulator (the port of ``chunky_bits_tpu/sim``).

Thousand-node fault scenarios in compressed virtual time, with the
metrics registry as the observer.  Four pieces:

* ``sim/loop.py`` — a virtual-time asyncio event loop: when nothing is
  runnable and no host-thread work is in flight, time jumps straight to
  the next timer, so a 60-minute scrub pass costs one callback of wall
  time, and every duration read through the clock seam
  (``utils/clock.py``) agrees on that virtual timebase.  ``sim.run(coro)``
  is the entry point.
* ``sim/fabric.py`` — the fault-injection node plane: in-process
  simulated storage nodes behind the ``Location`` surface (the ``sim:``
  kind, dispatched lazily as ``slab:`` is), each with a lognormal latency
  model and tail, a fault state machine (healthy → slow → erroring →
  partitioned → dead → recovering), zone topology and byte-accounted
  virtual bandwidth.
* ``sim/scenario.py`` — the scenario engine: scripted timelines over a
  generated namespace, with convergence and SLO detection verdicts and a
  seed-reproducible event trace (same seed ⇒ byte-identical trace).
* ``sim/crash.py`` — the crash-consistency harness: every "crash at op
  k" prefix of the storage plane's durability protocols, replayed through
  the filesystem seam (``utils/fsio.py``) and verified cold.

Production code paths import nothing from this package: the clock seam
defaults to the system clock, and ``file/location.py``'s ``sim:`` branches
import ``sim.fabric`` only when a sim location is touched.
"""

from chunky_bits_tpu_torch.sim.loop import VirtualTimeLoop, run  # noqa: F401

__all__ = ["VirtualTimeLoop", "run"]
