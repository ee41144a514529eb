"""CPU seconds of the host pipeline's worker threads in the window, as a
share of those workers times the window (their thread CPU clocks)."""

from gpubench.readers import host_cpu_pct


def read(run):
    return host_cpu_pct(run)
