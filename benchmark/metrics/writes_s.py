"""writes_s: the mean seconds an isolate of the window spends in the
program's "write_outputs" phases (one a write: the FASTQ copy, the
corrected calls, the GML, the allele FASTQs, the TSV), from its
phase_timings.json."""

from spans import phase_seconds


def read(run):
    return phase_seconds(run, ("write_outputs",))
