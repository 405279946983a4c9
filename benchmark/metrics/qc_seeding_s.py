"""qc_seeding_s: the mean seconds an isolate of the window spends in the
aligner's "align.seed" spans (seed chains on the host) under its
"ingest_gene_calls" phase, the consensus QC, from its phase_timings.json."""

from spans import span_seconds


def read(run):
    return span_seconds(run, "ingest_gene_calls", ("align.seed",))
