"""cluster_split_s: the mean seconds an isolate of the window spends in the
"cluster.split" spans (each AMR gene's paths split into alleles and their
reads) under its "path_clustering" phase, from its phase_timings.json."""

from spans import span_seconds


def read(run):
    return span_seconds(run, "path_clustering", ("cluster.split",))
