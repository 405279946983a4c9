"""sw_dp_rows_kept_pct: the share of the alignment jobs' query rows that the
aligner sends to sw_dp, in %: the "rows_kept" counters of its
"align.kernels" spans over their "rows_full" counters (each job's whole
query length), each summed over the window's isolates. A job keeps the rows
its band can reach. A program without these counters gives nothing."""

from spans import counter_total


def read(run):
    kept = counter_total(run, "align.kernels", "rows_kept")
    full = counter_total(run, "align.kernels", "rows_full")
    if kept is None or not full:
        return None
    return 100.0 * kept / full
