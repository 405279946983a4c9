"""The readings that a cell's limits are set from, in one process.

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,... \
        [--faults polish_unchanged,...] [--fault-seeds 7,8,9] [--out FILE]

After the cell's set-up (once), each seed's isolate runs once through the
same entry as the benchmark's window and is judged by the reference: first
every seed with the program as it is, then every fault of `faults.py`
(the control among them) on every fault seed. Each reading is one JSON line
on standard output (and appended to `--out`): the cell, seed, fault, the
isolate's wall seconds and the numbers `correct` compares. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys

import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    fault_seeds = [int(s) for s in args.fault_seeds.split(",") if s]
    plan = [(s, None) for s in seeds] + [
        (s, f) for f in args.faults.split(",") if f for s in fault_seeds
    ]
    run.cache_env()
    cell = run.Cell(args.workload, "cuda")
    cell.warm_up(seeds[0])
    for seed, fault in plan:
        files = cell.make_isolate(seed, f"input{seed}")
        with run.faults.planted(fault):
            rec = cell.window(files, 0)[0]
        line = {
            "cell": args.workload,
            "seed": seed,
            "fault": fault,
            "wall_s": rec["wall_s"],
            "phases": {p["phase"]: p["seconds"] for p in rec["phases"]},
            "numbers": cell.judge(rec, files),
            "error": rec["error"],
        }
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        shutil.rmtree(rec["out"], ignore_errors=True)
        shutil.rmtree(cell.work / f"input{seed}", ignore_errors=True)
    cell.close()
    found = run.loaded_forbidden()
    if found:
        sys.stderr.write(f"readings: JAX or the JAX package was loaded: {found}\n")
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
