"""Parts of the window's file references per dispatch of the cluster's
shared ``EncodeHashBatcher`` (its ``dispatches`` counter)."""

from gpubench.readers import parts_per_dispatch


def read(run):
    return parts_per_dispatch(run, "write", "encode.dispatches")
