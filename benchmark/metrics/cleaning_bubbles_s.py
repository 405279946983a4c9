"""cleaning_bubbles_s: the mean seconds an isolate of the window spends in
the "clean.bubbles" spans (the bubble-popping sweeps) under its
"graph_cleaning" phase, from its phase_timings.json."""

from spans import span_seconds


def read(run):
    return span_seconds(run, "graph_cleaning", ("clean.bubbles",))
