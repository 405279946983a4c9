"""qc_align_host_s: the mean seconds an isolate of the window spends in the
aligner's host work around the kernels, the "align.pack", "align.unpack"
and "align.stitch" spans, under its "ingest_gene_calls" phase (the
consensus QC), from its phase_timings.json."""

from spans import span_seconds


def read(run):
    return span_seconds(run, "ingest_gene_calls", ("align.pack", "align.unpack", "align.stitch"))
