"""The SHA kernel (``csrc/sha256_rows.cu``): its least time for the
window's launches (rows read once, or every compression's integer
operations on every lane) as a share of its summed device time."""

from gpubench.readers import sha256_rows_roofline


def read(run):
    return sha256_rows_roofline(run)
