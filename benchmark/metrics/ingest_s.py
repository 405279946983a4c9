"""ingest_s: the mean seconds an isolate of the window spends in the
program's phase(s) "ingest_gene_calls" (tracing.PhaseTimer)."""

from phases import mean_phase


def read(run):
    return mean_phase(run, ("ingest_gene_calls",))
