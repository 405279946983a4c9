"""Phases, spans and counters: the port's one tracing system.

The reference has no tracing (SURVEY §5.1: tqdm loops and one wall-clock
total). Here every step of a run lies in one named top-level phase
(`phase`); work inside a phase is divided into child spans (`span`), and
numbers of work done are added to the innermost open phase or span
(`count`). At the end the phases, with their spans nested under them, are
written to <output>/phase_timings.json and, unless quiet, printed as a
table with each phase's child spans merged by name and indented under it.

Every phase and span carries `start_ns` and `end_ns`, stamped with
`time.time_ns()`: the clock `torch.profiler` stamps its host and device
records with. To see the device, run `torch.profiler` around the CLI and
line its records up with phase_timings.json's stamps.

When the pipeline runs on a cuda device, each phase edge synchronises the
device first, so a phase's seconds include the device work it queued. A
span never synchronises: its seconds are host seconds, and device work
queued inside it and not waited for shows up in whichever span waits.

A batch (`batch.py`) runs isolates in threads, one CUDA stream each, so the
timer's phases, open phases and spans, and device belong to the calling
thread: each isolate's phase_timings.json holds its own phases, and a
phase edge waits for the current stream of its thread on the device (the
isolate's own work), not for the whole card.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from contextlib import contextmanager


class _ThreadState(threading.local):
    def __init__(self):
        self.phases: list[dict] = []
        # open phase and span entries, outermost first
        self.stack: list[dict] = []
        # torch device whose queued work a phase edge waits for (cuda only)
        self.device = None


class PhaseTimer:
    def __init__(self):
        self._local = _ThreadState()

    @property
    def phases(self) -> list[dict]:
        """This thread's finished phases, in the order they ended."""
        return self._local.phases

    def reset(self, device) -> None:
        """Start this thread's run on `device`: no phases yet."""
        self._local.phases = []
        self._local.device = device

    def _sync(self):
        dev = self._local.device
        if dev is not None and getattr(dev, "type", None) == "cuda":
            import torch

            torch.cuda.current_stream(dev).synchronize()

    @contextmanager
    def phase(self, name: str, **meta):
        self._sync()
        entry = {"phase": name, **meta, "start_ns": time.time_ns()}
        stack = self._local.stack
        stack.append(entry)
        try:
            yield entry
        finally:
            self._sync()
            entry["end_ns"] = time.time_ns()
            stack.pop()
            elapsed = (entry["end_ns"] - entry["start_ns"]) / 1e9
            entry["seconds"] = round(elapsed, 3)
            if "items" in entry:
                entry["items_per_sec"] = round(
                    entry["items"] / max(elapsed, 1e-9), 1
                )
            self.phases.append(entry)

    @contextmanager
    def span(self, name: str):
        """A child span of the innermost open phase or span of this
        thread; records nothing when no phase is open."""
        stack = self._local.stack
        if not stack:
            yield
            return
        entry = {"span": name, "start_ns": time.time_ns()}
        stack.append(entry)
        try:
            yield
        finally:
            entry["end_ns"] = time.time_ns()
            stack.pop()
            entry["seconds"] = round((entry["end_ns"] - entry["start_ns"]) / 1e9, 6)
            stack[-1].setdefault("spans", []).append(entry)

    def count(self, name: str, n=1) -> None:
        """Add `n` (a count, or seconds) to the innermost open phase's or
        span's counter `name`."""
        stack = self._local.stack
        if stack:
            counters = stack[-1].setdefault("counters", {})
            counters[name] = counters.get(name, 0) + n

    def finish(self, output_dir=None, quiet=False):
        if not quiet:
            total = sum(p["seconds"] for p in self.phases)
            sys.stderr.write("\namira-tpu phase timings:\n")
            for p in self.phases:
                rate = (
                    f"  ({p['items_per_sec']:.0f} {p.get('unit', 'items')}/s)"
                    if "items_per_sec" in p
                    else ""
                )
                label = p["phase"] + (f" ({p['output']})" if "output" in p else "")
                sys.stderr.write(
                    f"  {label:<40s} {p['seconds']:8.2f}s{rate}{_counters(p)}\n"
                )
                _write_spans(p.get("spans", []), 4)
            sys.stderr.write(f"  {'total':<40s} {total:8.2f}s\n")
        if output_dir is not None:
            with open(os.path.join(output_dir, "phase_timings.json"), "w") as o:
                json.dump(self.phases, o, indent=1)


def _counters(entry) -> str:
    """A phase's or span's counters for the table: counts as integers,
    seconds (floats) to the hundredth."""
    c = entry.get("counters")
    if not c:
        return ""
    return "  " + ", ".join(
        f"{k}={v:,}" if isinstance(v, int) else f"{k}={v:.2f}s" for k, v in c.items()
    )


def _write_spans(spans, indent):
    """The table's rows of `spans`, merged by name (count, seconds and
    counters summed), each followed by its own children one level in."""
    merged: dict = {}
    for s in spans:
        m = merged.setdefault(
            s["span"], {"n": 0, "seconds": 0.0, "counters": collections.Counter(), "spans": []}
        )
        m["n"] += 1
        m["seconds"] += s["seconds"]
        m["counters"].update(s.get("counters", {}))
        m["spans"] += s.get("spans", [])
    for name, m in merged.items():
        sys.stderr.write(
            f"{' ' * indent}{name:<{42 - indent}s} {m['seconds']:8.2f}s  x{m['n']}{_counters(m)}\n"
        )
        _write_spans(m["spans"], indent + 2)


TIMER = PhaseTimer()


def phase(name: str, **meta):
    return TIMER.phase(name, **meta)
