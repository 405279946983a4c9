"""load_fastq_s: the mean seconds an isolate of the window spends in the
program's phase(s) "load_fastq" (tracing.PhaseTimer)."""

from phases import mean_phase


def read(run):
    return mean_phase(run, ("load_fastq",))
