"""device_idle_pct: the share of the traced window in which no kernel, copy
or set ran on the card (the profiler's device records), in %."""


def read(run):
    trace = run.get("trace")
    if not trace:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
