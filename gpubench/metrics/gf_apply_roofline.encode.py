"""K1 (``csrc/gf_apply.cu``): its least time for the window's launches,
each input byte read and each output byte written once at the HBM rate,
as a share of its summed device time in the profiler's trace."""

from gpubench.readers import gf_apply_roofline


def read(run):
    return gf_apply_roofline(run)
