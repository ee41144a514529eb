"""The share of the traced window in which no kernel, copy or fill ran
on the card: one less the union of the device's intervals over the
window, from the profiler's trace."""

from gpubench.readers import device_idle_pct


def read(run):
    return device_idle_pct(run)
