"""cleaning_build_s: the mean seconds an isolate of the window spends in the
"clean.build" spans (the graph rebuilds) under its "graph_cleaning" phase,
from its phase_timings.json."""

from spans import span_seconds


def read(run):
    return span_seconds(run, "graph_cleaning", ("clean.build",))
