"""Order statistics for the benchmark's own numbers."""

from __future__ import annotations


def percentile(sorted_values: list, q: float) -> float:
    """Linear-interpolated percentile of an ascending-sorted list (numpy's
    'linear' method): the arithmetic of the port's
    ``file/profiler.py::percentile``, copied so that the yardstick lives
    with the benchmark."""
    if not sorted_values:
        return 0.0
    if len(sorted_values) == 1:
        return float(sorted_values[0])
    pos = (len(sorted_values) - 1) * (q / 100.0)
    lo = int(pos)
    hi = min(lo + 1, len(sorted_values) - 1)
    frac = pos - lo
    return float(sorted_values[lo]) * (1 - frac) \
        + float(sorted_values[hi]) * frac
