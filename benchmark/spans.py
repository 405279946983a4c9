"""What the span readers share: each window isolate's
`<output>/phase_timings.json`, as `tracing.PhaseTimer` writes it at the
isolate's end (top-level phases with `start_ns`/`end_ns` stamps, child
spans nested under `spans`, counters under `counters`), read from the
isolate's output directory before the run removes it.

An isolate without the file is skipped, and so is one in which a reader
finds nothing it reads (a program without these phases or spans, whose
file has no stamps either): a reader with nothing to read returns None.
Seconds come from the stamps (nanoseconds on the profiler's clock), not
from the rounded `seconds`.
"""

from __future__ import annotations

import json
import os


def timings(rec: dict) -> list | None:
    """The isolate's phase entries, or None without the file."""
    try:
        with open(os.path.join(rec["out"], "phase_timings.json")) as f:
            return json.load(f)
    except FileNotFoundError:  # the isolate failed before its end
        return None


def seconds(entry: dict) -> float:
    return (entry["end_ns"] - entry["start_ns"]) / 1e9


def spans_named(entry: dict, names: tuple[str, ...]):
    """The spans under `entry`, at any depth, whose name is in `names`."""
    for s in entry.get("spans", []):
        if s["span"] in names:
            yield s
        yield from spans_named(s, names)


def mean_of_isolates(run: dict, per_isolate) -> float | None:
    """The mean over the window's isolates of `per_isolate(phases)`, over
    the isolates where it is not None."""
    values = []
    for rec in run["isolates"]:
        phases = timings(rec)
        if phases is not None:
            value = per_isolate(phases)
            if value is not None:
                values.append(value)
    return sum(values) / len(values) if values else None


def phase_seconds(run: dict, names: tuple[str, ...]) -> float | None:
    """Mean seconds an isolate spends in the top-level phases `names`."""

    def per_isolate(phases):
        hit = [p for p in phases if p["phase"] in names]
        return sum(seconds(p) for p in hit) if hit else None

    return mean_of_isolates(run, per_isolate)


def span_seconds(run: dict, phase: str, names: tuple[str, ...]) -> float | None:
    """Mean seconds an isolate spends in the spans `names` under its
    phase(s) `phase`."""

    def per_isolate(phases):
        hit = [s for p in phases if p["phase"] == phase for s in spans_named(p, names)]
        return sum(seconds(s) for s in hit) if hit else None

    return mean_of_isolates(run, per_isolate)


def counter_total(run: dict, span: str, counter: str) -> int | None:
    """`counter` summed over every span `span` of every window isolate;
    None where no such span holds it."""
    total, seen = 0, False
    for rec in run["isolates"]:
        for p in timings(rec) or []:
            for s in spans_named(p, (span,)):
                if counter in s.get("counters", {}):
                    total += s["counters"][counter]
                    seen = True
    return total if seen else None
