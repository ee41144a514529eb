"""The clock seam of the cluster plane: ``utils/clock.py`` re-exported whole.

As in the JAX package, the implementation lives on the utils side so that
``file/`` modules can read the clock without importing the ``cluster``
package (whose ``__init__`` imports ``destination.py`` and with it
``file.location``).  Both names share one module-level state: ``install``
through either rebinds the one active clock.
"""

from __future__ import annotations

from chunky_bits_tpu_torch.utils.clock import (  # noqa: F401
    Clock,
    VirtualClock,
    active,
    install,
    monotonic,
    sleep,
    system_clock,
)

__all__ = [
    "Clock",
    "VirtualClock",
    "active",
    "install",
    "monotonic",
    "sleep",
    "system_clock",
]
