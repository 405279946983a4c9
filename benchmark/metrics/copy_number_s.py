"""copy_number_s: the mean seconds an isolate of the window spends in the
program's phase(s) "copy_number_estimation" (tracing.PhaseTimer)."""

from phases import mean_phase


def read(run):
    return mean_phase(run, ("copy_number_estimation",))
