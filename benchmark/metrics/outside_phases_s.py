"""outside_phases_s: the mean over the window's isolates of the isolate's
wall (ending in a synchronise) less the seconds of its phases: the output
writes and whatever else the phase timer does not time."""


def read(run):
    iso = run["isolates"]
    return sum(r["wall_s"] - sum(p["seconds"] for p in r["phases"]) for r in iso) / len(iso)
