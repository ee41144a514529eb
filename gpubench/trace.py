"""The traced run's device timeline, from ``torch.profiler``.

Device activity (kernels, copies, fills) comes from the profiler's CUDA
trace.  Its clock is tied to the host's monotonic clock by a marker: the
device is idle, the host notes the time and launches one small kernel,
and that kernel is the trace's first device activity.  From the aligned
timeline the summary gives the busy time (the union of device
intervals), each kernel's summed time, the operations that took most
time, and the longest idle gaps, each named by the harness span that was
open on the host while the device waited.
"""

from __future__ import annotations

import time
from typing import Optional

#: the harness's spans that can name an idle gap, most specific first
GAP_SPANS = ("writer.write",)


class DeviceTrace:
    def __init__(self, torch, device):
        self.torch = torch
        self.device = device
        self.prof = None
        self.t_mark_ns = 0

    def start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile

        marker = torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        torch.cuda.synchronize(self.device)
        self.t_mark_ns = time.monotonic_ns()
        marker.add_(1)
        torch.cuda.synchronize(self.device)

    def stop(self) -> None:
        self.torch.cuda.synchronize(self.device)
        self.prof.stop()

    def device_events(self) -> list[tuple[str, int, int]]:
        """(name, start, end) of every device activity, in host monotonic
        nanoseconds, the marker left out."""
        from torch.autograd import DeviceType

        raw = [(e.name(), e.start_ns(), e.end_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA]
        if not raw:
            return []
        raw.sort(key=lambda e: e[1])
        offset = raw[0][1] - self.t_mark_ns
        return [(name, t0 - offset, t1 - offset) for name, t0, t1 in raw[1:]]

    def summary(self, t_start: float, t_end: float,
                spans: list[tuple[str, float, float]]) -> Optional[dict]:
        lo, hi = int(t_start * 1e9), int(t_end * 1e9)
        events = [(n, max(a, lo), min(b, hi)) for n, a, b in
                  self.device_events() if b > lo and a < hi]
        if not events:
            return None
        by_name: dict[str, float] = {}
        for name, a, b in events:
            key = op_name(name)
            by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e9
        busy: list[list[int]] = []
        for _, a, b in sorted(events, key=lambda e: e[1]):
            if busy and a <= busy[-1][1]:
                busy[-1][1] = max(busy[-1][1], b)
            else:
                busy.append([a, b])
        gaps = []
        edge = lo
        for a, b in busy + [[hi, hi]]:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        gaps.sort(key=lambda g: g[0] - g[1])
        return {
            "busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": (hi - lo) / 1e9,
            "kernel_s": by_name,
            "device_ops": sorted(by_name.items(),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": [[gap_label(spans, (a + b) / 2e9), (b - a) / 1e9]
                          for a, b in gaps[:10]],
        }


def op_name(name: str) -> str:
    """A device activity's name without its parameter list: the kernel's
    function (``(anonymous namespace)::`` and a leading ``void`` left
    out), or the copy or fill as the profiler names it."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[len("void "):]
    return name.split("(")[0].strip() or name


def gap_label(spans: list[tuple[str, float, float]], t: float) -> str:
    """The most specific harness span open on the host at ``t``, with how
    many of that name were open."""
    open_now: dict[str, int] = {}
    for name, a, b in spans:
        if a <= t < b:
            open_now[name] = open_now.get(name, 0) + 1
    for name in GAP_SPANS:
        if name in open_now:
            return f"{name} x{open_now[name]}"
    return "no span open"


def kernel_seconds(run, kernel: str) -> float:
    """Summed device seconds of the kernel named ``kernel`` (its
    ``__global__`` function) in the traced window; 0 without a trace."""
    if not run.trace:
        return 0.0
    return sum(s for name, s in run.trace["kernel_s"].items()
               if kernel in name)
