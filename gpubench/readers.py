"""Arithmetic that several metric readers share.  Each metric's own file
in ``metrics/`` says which of these it takes and from which operations."""

from __future__ import annotations

from typing import Optional

from gpubench import roofline
from gpubench.stats import percentile
from gpubench.trace import kernel_seconds

GIB = float(1 << 30)


def rate_gib_s(run, kind: str) -> Optional[float]:
    """GiB/s of the answers of ``kind`` that arrived inside the window
    (a write's object when its reference returned), over the window."""
    mine = [op for op in run.ops if op.kind == kind]
    if not mine:
        return None
    return sum(op.window_bytes for op in mine) / run.window_s / GIB


def p95_ms(run, kind: str) -> Optional[float]:
    """95th percentile of the latency, from send to answer, of every op
    of ``kind`` sent in the window (an answer after the close counts with
    its wait)."""
    lat = sorted(op.t1 - op.t0 for op in run.submitted(kind)
                 if op.t1 is not None)
    return percentile(lat, 95) * 1e3 if lat else None


def parts_per_dispatch(run, kind: str, counter: str) -> Optional[float]:
    """Parts of the ``kind`` ops whose answers returned inside the window
    per dispatch of the batcher that ``counter`` counts in the window
    (the loops are steady, so the parts in flight at the window's two
    edges about cancel)."""
    dispatches = run.counters.get(counter, 0)
    parts = sum(op.parts for op in run.in_window(kind))
    return parts / dispatches if dispatches and parts else None


def host_cpu_pct(run) -> Optional[float]:
    """CPU seconds of the host pipeline's worker threads in the window,
    as a share of those workers times the window.  Jobs that run inline
    on a caller's thread, and the time a worker waits on the card, are
    not in it."""
    cpu = run.counters.get("host.worker_cpu_s")
    threads = run.counters.get("host.threads")
    if not cpu or not threads:
        return None
    return 100.0 * cpu / (threads * run.window_s)


def loop_cpu_pct(run) -> Optional[float]:
    """CPU seconds of the event loop's thread (the one the writers'
    coroutines, the batcher and the staging run on) in the window, as a
    share of the window."""
    cpu = run.counters.get("loop.cpu_s")
    return 100.0 * cpu / run.window_s if cpu else None


def gf_apply_roofline(run) -> Optional[float]:
    """K1's least time for the window's launches (their shapes) as a
    share of its summed device time."""
    shapes = run.launches.get("gf_apply", [])
    t = kernel_seconds(run, "gf_apply_kernel")
    if not shapes or t <= 0:
        return None
    return 100.0 * sum(roofline.gf_apply_bound_s(*s) for s in shapes) / t


def sha256_rows_roofline(run) -> Optional[float]:
    shapes = run.launches.get("sha256_rows", [])
    t = kernel_seconds(run, "sha256_rows_kernel")
    if not shapes or t <= 0:
        return None
    return 100.0 * sum(roofline.sha256_rows_bound_s(*s)
                       for s in shapes) / t


def device_idle_pct(run) -> Optional[float]:
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
