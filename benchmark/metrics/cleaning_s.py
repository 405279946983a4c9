"""cleaning_s: the mean seconds an isolate of the window spends in the
program's phase(s) "graph_cleaning" (tracing.PhaseTimer)."""

from phases import mean_phase


def read(run):
    return mean_phase(run, ("graph_cleaning",))
