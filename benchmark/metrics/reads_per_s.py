"""reads_per_s: every read of every isolate in the window over the seconds
from the first isolate's start to the last one's end (host clock)."""


def read(run):
    iso = run["isolates"]
    return run["reads"] * len(iso) / (iso[-1]["end"] - iso[0]["start"])
