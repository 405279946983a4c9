"""sw_dp_roofline: the summed bound of every sw_dp launch in the traced
window (bounds.dp_bound, from each launch's own inputs) over the kernel's
device seconds in the profiler's records, in %."""

from phases import roofline_pct


def read(run):
    return roofline_pct(run, "sw_dp")
