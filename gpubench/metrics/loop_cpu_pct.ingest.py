"""CPU seconds of the event loop's thread in the window, as a share of
the window (its thread CPU clock): how near the one thread that runs the
writers' coroutines is to its limit."""

from gpubench.readers import loop_cpu_pct


def read(run):
    return loop_cpu_pct(run)
