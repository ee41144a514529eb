"""95th percentile of every object write's latency in the window, from
submit to the returned file reference (host clock).  A per-layer metric:
its runs spread too widely to carry a bound (PERF.md, section 2)."""

from gpubench.readers import p95_ms


def read(run):
    return p95_ms(run, "write")
