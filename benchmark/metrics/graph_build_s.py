"""graph_build_s: the mean seconds an isolate of the window spends in the
program's phase(s) "initial_graph_build", "final_graph_build" (tracing.PhaseTimer)."""

from phases import mean_phase


def read(run):
    return mean_phase(run, ("initial_graph_build", "final_graph_build",))
