"""sw_dp_gcells_per_s: the DP cells of every sw_dp launch in the traced
window, the "live_cells" counters of the aligner's "align.kernels" spans
summed over the window's isolates, over sw_dp_kernel's device seconds in
the profiler's records, in 1e9 cells a second. Times 39 int32 operations
a cell (bounds.SW_DP_OPS_PER_CELL) over bounds.INT32_OPS_PER_S it is the
kernel's share of its operations bound."""

import devtrace
from spans import counter_total


def read(run):
    trace = run.get("trace")
    if not trace:
        return None
    seconds = devtrace.kernel_seconds(trace, "sw_dp_kernel")
    cells = counter_total(run, "align.kernels", "live_cells")
    if seconds <= 0 or cells is None:
        return None
    return cells / seconds / 1e9
