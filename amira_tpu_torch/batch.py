"""Multi-isolate batch driver: isolate-level parallelism on one host
(BASELINE config 4: 32 ESKAPE+E. coli isolates per host).

Port of `amira_tpu/batch.py`. The reference processes one isolate per CLI
invocation (amira/__main__.py); there is no batch mode. Here isolates share
one process: the kernels are built and loaded once for the whole batch, and
isolates round-robin over the visible devices of `--device` (every cuda:N
for "cuda", or the one device of "cuda:N" or "cpu"). Isolate i runs on
device i % n, passed to the pipeline as its `args.device`. Isolates share
nothing, so no work crosses between them.

Each worker thread runs its isolates on its own CUDA stream of their device
(torch's current stream belongs to the thread, so the pipeline's kernels,
copies and phase-edge waits all use it): `--workers 4` on one card gives
four streams on it. Host Python holds the interpreter lock, so threads
overlap only the device work and the native code that releases it.

Usage:
    python -m amira_tpu_torch.batch manifest.json [--workers N]
        [--output-root DIR] [--device cuda|cuda:N|cpu]

The manifest is a JSON list; each entry is a dict of CLI flags for one
isolate, exactly as accepted by `python -m amira_tpu_torch` (long names
without the leading dashes), e.g.:

    [{"name": "iso1", "pandoraJSON": "...", "gene-positions": "...",
      "reads": "...", "species": "Escherichia_coli", "output": "out/iso1"},
     ...]

`name` is optional (defaults to isolate_<i>) and is used for the output
subdirectory when `output` is not given explicitly.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from concurrent.futures import ThreadPoolExecutor


def _entry_to_argv(entry: dict, output_root: str | None, idx: int) -> list[str]:
    entry = dict(entry)
    name = entry.pop("name", f"isolate_{idx}")
    if "output" not in entry:
        root = output_root or "amira_batch_output"
        entry["output"] = os.path.join(root, name)
    argv: list[str] = []
    for key, value in entry.items():
        flag = f"--{key}" if len(key) > 1 else f"-{key}"
        if value is True:
            argv.append(flag)
        elif value is False or value is None:
            continue
        else:
            argv += [flag, str(value)]
    return argv


def run_isolate(argv: list[str], device=None) -> dict:
    """Run one isolate's pipeline, on `device` (its `args.device`) if given."""
    from .__main__ import get_options
    from .pipeline import run_pipeline

    args = get_options(argv)
    if device is not None:
        args.device = str(device)
    start = time.time()
    status = "ok"
    try:
        run_pipeline(args)
    except SystemExit as e:
        # the pipeline exits 0 early when no AMR genes survive — that is a
        # valid per-isolate outcome, not a batch failure
        status = "ok" if e.code in (None, 0) else f"exit {e.code}"
    except Exception as e:  # noqa: BLE001 — one bad isolate must not sink the batch
        status = f"error: {type(e).__name__}: {e}"
        sys.stderr.write(
            f"\namira-tpu batch: isolate failed ({status}): {argv}\n"
            f"{traceback.format_exc()}"
        )
    return {
        "output": args.output_dir,
        "status": status,
        "seconds": round(time.time() - start, 2),
        "results_tsv": os.path.join(args.output_dir, "amira_results.tsv"),
    }


def run_batch(
    manifest: list[dict],
    output_root: str | None = None,
    workers: int | None = None,
    quiet: bool = False,
    device="cuda",
) -> list[dict]:
    """Process every isolate in the manifest; returns per-isolate summaries.

    workers defaults to the number of devices `device` spans: one isolate
    stream per device. Each worker thread runs its isolates under a CUDA
    stream of its own on their device (none on the CPU)."""
    import torch

    from . import visible_devices

    devices = visible_devices(device)
    if workers is None:
        workers = len(devices)
    workers = max(1, min(workers, len(manifest)))
    jobs = [
        (_entry_to_argv(entry, output_root, i), devices[i % len(devices)])
        for i, entry in enumerate(manifest)
    ]
    streams = threading.local()

    def work(job):
        argv, dev = job
        if dev.type != "cuda":
            return run_isolate(argv, dev)
        own = streams.__dict__.setdefault("by_device", {})
        if dev not in own:
            own[dev] = torch.cuda.Stream(dev)
        with torch.cuda.stream(own[dev]):
            return run_isolate(argv, dev)

    t0 = time.time()
    if workers == 1:
        summaries = [work(j) for j in jobs]
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            summaries = list(pool.map(work, jobs))
    wall = time.time() - t0
    if not quiet:
        done = sum(1 for s in summaries if s["status"] == "ok")
        sys.stderr.write(
            f"\namira-tpu batch: {done}/{len(summaries)} isolates in "
            f"{wall:.1f}s over {workers} stream(s) on {len(devices)} "
            f"device(s).\n"
        )
    return summaries


def main(argv=None) -> None:
    import argparse

    from .__main__ import device_name

    parser = argparse.ArgumentParser(
        prog="amira-tpu-torch-batch",
        description="Process a batch of isolates (one device stream each).",
    )
    parser.add_argument("manifest", help="JSON list of per-isolate CLI flag dicts")
    parser.add_argument("--workers", type=int, default=None)
    parser.add_argument("--output-root", dest="output_root", default=None)
    parser.add_argument("--quiet", action="store_true", default=False)
    parser.add_argument(
        "--device", type=device_name, default="cuda",
        help="cuda (every visible card), cuda:N or cpu (default=cuda; no "
        "silent fallback to the CPU).",
    )
    args = parser.parse_args(argv)
    with open(args.manifest) as fh:
        manifest = json.load(fh)
    summaries = run_batch(
        manifest, args.output_root, args.workers, args.quiet, args.device
    )
    print(json.dumps(summaries, indent=2))


if __name__ == "__main__":
    main()
