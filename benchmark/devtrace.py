"""The traced window's device record, from `torch.profiler` run by the
benchmark around the window (CUDA activity only, so the host's work is
not traced and the traced window stays near the untraced one).

From the profiler's device records (kernels, copies, sets) it takes: the
seconds in which anything ran on the card (the union of the records), each
kernel's device seconds by name, the device operations that took most
time, and the idle gaps between records, each named by the pipeline phase
the host spent most of the gap in (phase spans the benchmark records
around the program's phase timer). Kineto stamps records on the wall
clock; spans are taken on the host's monotonic clock and moved onto it by
one offset read at the window's start.
"""

from __future__ import annotations

import collections
import time

TOP = 10
NAME_CHARS = 160


class Profiler:
    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CUDA])

    def __enter__(self):
        self._prof.__enter__()
        # perf_counter seconds -> wall-clock seconds
        self.offset = time.time() - time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        return False

    def device_records(self) -> list[tuple[str, float, float]]:
        """(name, start, end) of every record on the card, in perf_counter
        seconds."""
        from torch.autograd import DeviceType

        out = []
        for ev in self._prof.profiler.kineto_results.events():
            if ev.device_type() == DeviceType.CUDA:
                start = ev.start_ns() / 1e9 - self.offset
                out.append((ev.name(), start, start + ev.duration_ns() / 1e9))
        return out


def summarise(records, t0: float, t1: float, spans) -> dict:
    """The window [t0, t1]'s device numbers: busy seconds, kernel seconds
    by name, the top device operations and the longest idle gaps named by
    the host's phase (`spans`: (phase, start, end))."""
    clipped = sorted((max(s, t0), min(e, t1), n) for n, s, e in records if e > t0 and s < t1)
    by_name: dict = collections.Counter()
    for s, e, n in clipped:
        by_name[n] += e - s
    busy = 0.0
    gaps = []
    cursor = t0
    for s, e, _n in clipped:
        if s > cursor:
            gaps.append((cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if t1 > cursor:
        gaps.append((cursor, t1))

    def phase_of(a, b):
        """The phase the host spent most of [a, b] in."""
        cover = collections.Counter()
        for name, s, e in spans:
            cover[name] += max(0.0, min(b, e) - max(a, s))
        cover["outside_phases"] = (b - a) - sum(cover.values())
        return cover.most_common(1)[0][0]

    gaps.sort(key=lambda g: g[0] - g[1])
    return {
        "busy_s": busy,
        "window_s": t1 - t0,
        "records": len(clipped),
        "by_name": dict(by_name),
        "device_ops": [[n[:NAME_CHARS], s] for n, s in by_name.most_common(TOP)],
        "idle_gaps": [[phase_of(a, b), b - a] for a, b in gaps[:TOP]],
    }


def kernel_seconds(summary: dict, kernel: str) -> float:
    """Device seconds of the records whose name holds `kernel`."""
    return sum(s for n, s in summary["by_name"].items() if kernel in n)
