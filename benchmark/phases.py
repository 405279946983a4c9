"""What the per-layer readers share: the program's phases of each isolate
of the window (`tracing.PhaseTimer`'s `phase_timings`, one entry a phase)."""

from __future__ import annotations


def mean_phase(run: dict, names: tuple[str, ...]) -> float | None:
    """Mean over the window's isolates of their seconds in `names`; None
    when no isolate ran any of them."""
    per = [sum(p["seconds"] for p in rec["phases"] if p["phase"] in names) for rec in run["isolates"]]
    seen = any(p["phase"] in names for rec in run["isolates"] for p in rec["phases"])
    return sum(per) / len(per) if seen else None


def roofline_pct(run: dict, kernel: str) -> float | None:
    """Share (%) of `kernel`'s device time that its launches' bounds
    account for; None without a trace or without device time."""
    trace = run.get("trace")
    if not trace:
        return None
    import devtrace

    seconds = devtrace.kernel_seconds(trace, f"{kernel}_kernel")
    if seconds <= 0:
        return None
    return 100.0 * run["kernel_bounds_ms"][kernel] / (1e3 * seconds)
