"""clustering_s: the mean seconds an isolate of the window spends in the
program's phase(s) "path_clustering" (tracing.PhaseTimer)."""

from phases import mean_phase


def read(run):
    return mean_phase(run, ("path_clustering",))
