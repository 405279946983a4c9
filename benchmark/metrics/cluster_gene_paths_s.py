"""cluster_gene_paths_s: the mean seconds an isolate of the window spends
in the "cluster.gene_paths" spans (each AMR gene's node and gene-call
indexes, anchors, blocks, contexts and full paths) under its
"path_clustering" phase, from its phase_timings.json."""

from spans import span_seconds


def read(run):
    return span_seconds(run, "path_clustering", ("cluster.gene_paths",))
