"""sw_traceback_roofline: the summed bound of every sw_traceback launch in
the traced window (bounds.tb_bound) over the kernel's device seconds in the
profiler's records, in %."""

from phases import roofline_pct


def read(run):
    return roofline_pct(run, "sw_traceback")
