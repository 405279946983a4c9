"""graph_trim_s: the mean seconds an isolate of the window spends in the
program's phases "graph_trim" (from the initial build to cleaning: the
trim, re-threading, rebuild and junk-read filter) and "graph_prune" (after
the final build), from its phase_timings.json."""

from spans import phase_seconds


def read(run):
    return phase_seconds(run, ("graph_trim", "graph_prune"))
