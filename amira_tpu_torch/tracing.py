"""Phase timing and profiling.

The reference has no tracing (SURVEY §5.1: tqdm loops and one wall-clock
total). Here every pipeline stage runs under a named phase timer; a summary
(with reads/sec for the graph-build phases) is printed at exit and written to
<output>/phase_timings.json. When the pipeline runs on a cuda device, each
phase edge synchronises the device first, so a phase's seconds include the
device work it queued. Set AMIRA_TPU_PROFILE=<dir> to also capture a
torch.profiler trace (CPU and CUDA activity) of the run into <dir>.

A batch (`batch.py`) runs isolates in threads, one CUDA stream each, so the
timer's phases, open-phase stack and device belong to the calling thread:
each isolate's phase_timings.json holds its own phases, and a phase edge
waits for the current stream of its thread on the device (the isolate's
own work), not for the whole card. The profiler is one per process.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from contextlib import contextmanager


class _ThreadState(threading.local):
    def __init__(self):
        self.phases: list[dict] = []
        self.stack: list[tuple[str, float, dict]] = []
        # torch device whose queued work a phase edge waits for (cuda only)
        self.device = None


class PhaseTimer:
    def __init__(self):
        self._local = _ThreadState()
        self._profile_dir = os.environ.get("AMIRA_TPU_PROFILE")
        self._profiler = None
        self._profiler_lock = threading.Lock()

    @property
    def phases(self) -> list[dict]:
        """This thread's finished phases, in the order they ended."""
        return self._local.phases

    @property
    def _stack(self) -> list[tuple[str, float, dict]]:
        """This thread's open phases, outermost first: (name, start, entry)."""
        return self._local.stack

    def reset(self, device) -> None:
        """Start this thread's run on `device`: no phases yet."""
        self._local.phases = []
        self._local.device = device

    def _sync(self):
        dev = self._local.device
        if dev is not None and getattr(dev, "type", None) == "cuda":
            import torch

            torch.cuda.current_stream(dev).synchronize()

    def _start_profiler(self):
        with self._profiler_lock:
            if self._profiler is not None:
                return
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=activities)
            self._profiler.__enter__()

    @contextmanager
    def phase(self, name: str, **meta):
        if self._profile_dir and self._profiler is None:
            self._start_profiler()
        self._sync()
        start = time.time()
        entry = {"phase": name, **meta}
        self._stack.append((name, start, entry))
        try:
            yield entry
        finally:
            self._sync()
            _name, start, entry = self._stack.pop()
            elapsed = time.time() - start
            entry["seconds"] = round(elapsed, 3)
            if "items" in entry:
                entry["items_per_sec"] = round(
                    entry["items"] / max(elapsed, 1e-9), 1
                )
            self.phases.append(entry)

    def finish(self, output_dir=None, quiet=False):
        with self._profiler_lock:
            if self._profiler is not None:
                self._profiler.__exit__(None, None, None)
                os.makedirs(self._profile_dir, exist_ok=True)
                self._profiler.export_chrome_trace(
                    os.path.join(self._profile_dir, "trace.json")
                )
                self._profiler = None
        if not quiet:
            total = sum(p["seconds"] for p in self.phases)
            sys.stderr.write("\namira-tpu phase timings:\n")
            for p in self.phases:
                rate = (
                    f"  ({p['items_per_sec']:.0f} {p.get('unit', 'items')}/s)"
                    if "items_per_sec" in p
                    else ""
                )
                sys.stderr.write(
                    f"  {p['phase']:<32s} {p['seconds']:8.2f}s{rate}\n"
                )
            sys.stderr.write(f"  {'total':<32s} {total:8.2f}s\n")
        if output_dir is not None:
            with open(os.path.join(output_dir, "phase_timings.json"), "w") as o:
                json.dump(self.phases, o, indent=1)


class ThreadSeconds(threading.local):
    """Named seconds counters, starting at 0.0, with one set per thread;
    indexed and iterated like a dict of them."""

    def __init__(self, names):
        self._seconds = dict.fromkeys(names, 0.0)

    def __getitem__(self, name):
        return self._seconds[name]

    def __setitem__(self, name, value):
        self._seconds[name] = value

    def __iter__(self):
        return iter(self._seconds)

    def items(self):
        return self._seconds.items()


TIMER = PhaseTimer()


def phase(name: str, **meta):
    return TIMER.phase(name, **meta)
