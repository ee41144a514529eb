"""GiB/s of objects whose file reference returned inside the window,
over the whole window (host clock)."""

from gpubench.readers import rate_gib_s


def read(run):
    return rate_gib_s(run, "write")
