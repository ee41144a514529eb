"""What one run leaves for its metric readers: the operations of the
window, the harness's spans and counters, and the device trace."""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class Op:
    """One request of the traffic: an object written."""

    kind: str          # the operation's name: "write"
    key: int           # which object (the source bytes it stands for)
    nbytes: int        # bytes of the object
    t0: float          # submitted (host monotonic seconds)
    t1: Optional[float] = None   # answered; None if it never came
    ok: bool = False   # answered whole, of the expected length
    parts: int = 0     # parts of a written object's file reference
    answer: object = None        # what the check compares
    #: bytes of the answer that arrived inside the window
    window_bytes: int = 0
    client: int = 0    # the closed loop's client that sent it


class Spans:
    """Spans the harness records around its calls into each layer:
    ``(name, start, end)`` on the host's monotonic clock.  Off unless the
    run is traced."""

    def __init__(self, on: bool):
        self.on = on
        self.items: list[tuple[str, float, float]] = []
        self._lock = threading.Lock()

    def add(self, name: str, t0: float, t1: float) -> None:
        if self.on:
            with self._lock:
                self.items.append((name, t0, t1))


@dataclass
class Run:
    """A run of one cell, as the metric readers see it."""

    workload: str
    config: dict
    traffic: dict
    setup_s: float = 0.0
    t_start: float = 0.0   # the window, host monotonic seconds
    t_end: float = 0.0
    ops: list[Op] = field(default_factory=list)
    #: counters read at the window's start and end, by name: the end
    #: value less the start value
    counters: dict = field(default_factory=dict)
    #: kernel launches in the window by kernel: shapes, traced runs only
    launches: dict = field(default_factory=dict)
    #: the device trace's summary, traced runs only
    trace: Optional[dict] = None
    #: the host pipeline's stages and the process's CPU seconds in the
    #: window, printed on standard error
    notes: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def in_window(self, kind: str) -> list[Op]:
        """Ops of ``kind`` answered whole inside the window."""
        return [op for op in self.ops if op.kind == kind and op.ok
                and op.t1 is not None
                and self.t_start <= op.t1 <= self.t_end]

    def submitted(self, kind: str) -> list[Op]:
        """Every op of ``kind`` sent inside the window."""
        return [op for op in self.ops if op.kind == kind
                and self.t_start <= op.t0 < self.t_end]

    def due(self, kind: Optional[str] = None) -> list[Op]:
        """Every op (of ``kind``) sent or answered inside the window: the
        answers the check compares."""
        return [op for op in self.ops if kind in (None, op.kind)
                and (op.t0 >= self.t_start or op.t1 is None
                     or op.t1 >= self.t_start)]
