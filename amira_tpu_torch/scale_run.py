"""The 500,000-read ceiling run on the port: `python -m amira_tpu_torch.scale_run`.

Twin of the repo's `scale_run.py`, which drives the JAX package. It
generates a synthetic isolate at the reference's subsample ceiling (500,000
reads; a 4,003-slot E. coli-like genome with amrX at two loci and amrY at
one, 10-20 genes of 400 bp a read, 5 % pandora-style call noise, 2 %/1 %
base errors, seed 17), runs the port's whole pipeline on it (ingest ->
`amira_results.tsv`) and writes a per-phase report from the pipeline's own
`phase_timings.json`.

    python -m amira_tpu_torch.scale_run [--reads 500000] [--device cuda]
        [--workdir DIR] [--report PATH] [--reuse] [--generate-only]

`--device` takes cuda, cuda:N or cpu (default cuda; without CUDA it raises,
it never falls back to the CPU). The isolate, the output and the report go
under `--workdir` (default `chip_work/scale_run/` in the checkout, which
.gitignore lists): the isolate's files, `out/` (the pipeline's output),
`out/SCALE_REPORT.md` and `out/scale_summary.json`.

Generation lives here, in one place, for this script, `accuracy_run.py`'s
twin and `chip_smoke.py`: the layout (`scale_layout`), the `make_isolate`
arguments (`isolate_kwargs`) and the `--reuse` marker
(`.generated_<reads>_<tag>`, computed as `scale_run.py` computes it, so
either script's `--reuse` takes the other's workdir). It runs in a child
process with PYTHONHASHSEED=0: `make_isolate` draws gene sequences in the
order of a set of names, which follows string hashing, so only a fixed hash
seed gives the same bases in every run. The generator is
`tests/synthetic.py`, imported from the checkout's `tests/` directory.
"""

from __future__ import annotations

import argparse
import csv
import gzip
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

from . import PACKAGE_DIR

ROOT = os.path.dirname(PACKAGE_DIR)
TESTS_DIR = os.path.join(ROOT, "tests")
DEFAULT_WORKDIR = os.path.join(ROOT, "chip_work", "scale_run")
# the native FASTQ reader reads a file whole up to this size and streams a
# larger one (native/_fastio.c, FASTQ_WHOLE_FILE_MAX_BYTES)
FASTQ_WHOLE_FILE_MAX_BYTES = 256 << 20
# make_isolate's output files, by the key of its returned dict
ISOLATE_FILES = (
    ("calls", "calls.json"),
    ("positions", "positions.json"),
    ("fastq", "reads.fastq.gz"),
    ("amr_fasta", "AMR_alleles_unified.fa"),
    ("amr_calls", "AMR_calls.json"),
    ("core_genes", "core_genes.txt"),
    ("plasmid_genes", "plasmid_genes.txt"),
    ("truth", "truth.json"),
)


def scale_layout() -> list[str]:
    """The 4,003-slot genome: ~4,000 single-copy genes (an E. coli-like gene
    count, so 500k reads give ~1,900x per-gene depth), amrX at two loci and
    amrY at one."""
    layout = []
    for i in range(4000):
        layout.append(f"gene{i}")
        if i in (500, 2900):
            layout.append("amrX")
        if i == 1700:
            layout.append("amrY")
    return layout


def isolate_kwargs(seed: int = 17, **extra) -> dict:
    """`make_isolate`'s arguments for the scale isolate (seed 17; the
    accuracy run passes seed 23 and its `sub`/`indel`). The marker's tag is
    a hash of exactly these, so they match scale_run.py's key for key."""
    return dict(
        seed=seed,
        layout=scale_layout(),
        amr_genes=("amrX", "amrY"),
        genes_per_read=(10, 20),
        gene_len=400,
        fast=True,
        call_noise=0.05,
        **extra,
    )


def marker_path(workdir: str, n_reads: int, kwargs: dict) -> str:
    """scale_run.py's `--reuse` marker for an isolate of `n_reads` reads made
    with `kwargs`."""
    params = tuple(sorted((k, repr(v)) for k, v in kwargs.items()))
    tag = hashlib.sha1(repr(params).encode()).hexdigest()[:10]
    return os.path.join(workdir, f".generated_{n_reads}_{tag}")


def fastq_sha256(path: str) -> str:
    """SHA-256 of a gzip FASTQ's decompressed bytes."""
    digest = hashlib.sha256()
    with gzip.open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _generate_here(workdir: str, n_reads: int, kwargs_json: str) -> None:
    """The generation child's body: make_isolate into `workdir`, then a
    record of its files, the FASTQ's SHA-256 and the seconds
    (`<marker>.json`), then the marker itself, last."""
    from synthetic import make_isolate

    extra = json.loads(kwargs_json)
    kwargs = isolate_kwargs(**extra)
    marker = marker_path(workdir, n_reads, kwargs)
    t0 = time.time()
    files = make_isolate(workdir, n_reads=n_reads, **kwargs)
    gen_s = time.time() - t0
    files["fastq_sha256"] = fastq_sha256(files["fastq"])
    files["generation_seconds"] = gen_s
    with open(marker + ".json", "w") as f:
        json.dump(files, f)
    with open(marker, "w") as f:
        f.write("ok\n")


def start_generation(workdir: str, n_reads: int, **extra) -> tuple:
    """Starts generating an isolate of `n_reads` reads with
    `isolate_kwargs(**extra)` into `workdir`, in a child process with
    PYTHONHASHSEED=0; returns a handle for wait_generation."""
    os.makedirs(workdir, exist_ok=True)
    for name in os.listdir(workdir):  # a stale marker must not outlive its files
        if name.startswith(".generated_"):
            os.remove(os.path.join(workdir, name))
    env = dict(os.environ, PYTHONHASHSEED="0")
    env["PYTHONPATH"] = os.pathsep.join([ROOT, TESTS_DIR])
    code = (
        "from amira_tpu_torch.scale_run import _generate_here; "
        f"_generate_here({workdir!r}, {n_reads}, {json.dumps(extra)!r})"
    )
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env)
    return proc, workdir, n_reads, extra


def wait_generation(handle) -> dict:
    """Waits for start_generation's child; returns make_isolate's dict plus
    `fastq_sha256` and `generation_seconds` (make_isolate's, in the child)."""
    proc, workdir, n_reads, extra = handle
    if proc.wait() != 0:
        raise RuntimeError(f"generating the isolate in {workdir} failed (exit {proc.returncode})")
    marker = marker_path(workdir, n_reads, isolate_kwargs(**extra))
    with open(marker + ".json") as f:
        files = json.load(f)
    return files


def generate(workdir: str, n_reads: int, reuse: bool = False, **extra) -> dict:
    """The isolate of `n_reads` reads with `isolate_kwargs(**extra)` in
    `workdir`, as wait_generation returns it. With `reuse` and the marker
    present it is not generated again (`generation_seconds` 0, `reused`
    True; the paths are `workdir`'s); a workdir that scale_run.py made has
    no record, so its FASTQ is hashed here."""
    marker = marker_path(workdir, n_reads, isolate_kwargs(**extra))
    if reuse and os.path.exists(marker):
        files = {"n_reads": n_reads}
        if os.path.exists(marker + ".json"):
            with open(marker + ".json") as f:
                files = json.load(f)
        # the workdir may have been copied or moved since its record was made
        files.update({k: os.path.join(workdir, fn) for k, fn in ISOLATE_FILES})
        if "fastq_sha256" not in files:
            files["fastq_sha256"] = fastq_sha256(files["fastq"])
        files.update(generation_seconds=0.0, reused=True)
        return files
    files = wait_generation(start_generation(workdir, n_reads, **extra))
    files["reused"] = False
    return files


def cli_argv(files: dict, out: str, device: str) -> list[str]:
    """The port's CLI arguments for a generated isolate."""
    return [
        "--pandoraJSON", files["calls"],
        "--gene-positions", files["positions"],
        "--reads", files["fastq"],
        "--species", "Escherichia_coli",
        "--amr-fasta", files["amr_fasta"],
        "--amr-calls", files["amr_calls"],
        "--core-genes", files["core_genes"],
        "--plasmid-genes", files["plasmid_genes"],
        "--output", out,
        "--device", device,
    ]


def run_cli(argv: list[str]) -> None:
    """The port's CLI; a clean SystemExit passes, any other raises."""
    from .__main__ import main as amira_main

    try:
        amira_main(argv)
    except SystemExit as e:
        if e.code not in (None, 0):
            raise


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    index = 0 if device.index is None else device.index
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()
        return lines[index]
    except (OSError, subprocess.CalledProcessError, IndexError):
        import torch

        return f"{torch.cuda.get_device_name(device)} (power limit not read: no nvidia-smi)"


def host_memory_total() -> int | None:
    """`free -b`'s total of the host's memory, in bytes."""
    try:
        out = subprocess.run(["free", "-b"], capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return None
    for line in out.splitlines():
        if line.startswith("Mem:"):
            return int(line.split()[1])
    return None


def commit() -> str | None:
    """The checkout's commit (with "-dirty" when files differ from it), or
    None where there is no git history."""
    try:
        head = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True, check=True,
        ).stdout.strip()
        dirty = subprocess.run(
            ["git", "status", "--porcelain", "--untracked-files=no"],
            cwd=ROOT, capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None
    return head + ("-dirty" if dirty else "")


def read_rows(out: str) -> list[dict]:
    """amira_results.tsv's rows, as dicts of strings."""
    with open(os.path.join(out, "amira_results.tsv")) as f:
        return list(csv.DictReader(f, delimiter="\t"))


def phase_seconds(phases) -> dict:
    """Seconds by phase name, in the order the names first ended (a phase
    entered more than once, as `write_outputs`, is summed)."""
    out: dict = {}
    for p in phases:
        out[p["phase"]] = out.get(p["phase"], 0.0) + p["seconds"]
    return out


def cleaning_stages(phases) -> dict | None:
    """Seconds of the `graph_cleaning` phase's `clean.*` spans by name, and
    the `clean.bubbles` spans' counters as `clean.bubbles.<counter>`; None
    without the phase."""
    stages = None
    for p in phases:
        if p["phase"] != "graph_cleaning":
            continue
        stages = stages or {}
        for s in p.get("spans", []):
            stages[s["span"]] = stages.get(s["span"], 0.0) + s["seconds"]
            if s["span"] == "clean.bubbles":
                for k, v in s.get("counters", {}).items():
                    key = f"clean.bubbles.{k}"
                    stages[key] = stages.get(key, 0.0) + v
    return stages


def _report(args, files, summary, phases) -> str:
    rows = []
    phase_total = sum(p["seconds"] for p in phases)
    for p in phases:
        pct = 100.0 * p["seconds"] / max(phase_total, 1e-9)
        extra = f" ({p['items_per_sec']:.0f} {p.get('unit','items')}/s)" if "items_per_sec" in p else ""
        rows.append(f"| {p['phase']} | {p['seconds']:.1f} | {pct:.1f}% |{extra} |")
    clustering_s = sum(p["seconds"] for p in phases if "clustering" in p["phase"])
    total_s = summary["seconds"]
    peak = summary["peak_device_memory_bytes"]
    peak_txt = "not measured (cpu)" if peak is None else f"{peak:,} bytes ({peak / 2**30:.2f} GiB)"
    host = summary["host_memory_total_bytes"]
    host_txt = "unknown" if host is None else f"{host:,}"
    shapes = ", ".join(f"({b}, {lq}, {w}) x {n}" for b, lq, w, n in summary["sw_dp_shapes"]) or "none"
    return f"""# 500k-read ceiling run (PyTorch/CUDA port)

Synthetic isolate at the reference's subsample ceiling (upstream
amira's `__main__.py:136-142`): **{args.reads:,} reads**,
{len(scale_layout()):,}-slot genome (E. coli-like gene count), amrX at two genomic
loci + amrY, 10-20 genes/read,
5% pandora-style call noise (drops/strand flips), 2%/1% sub/indel
sequence error. Generated in {files['generation_seconds']:.0f}s (vectorized simulator,
tests/synthetic.py:mutate_fast).

Platform: **{summary['platform']}** · end-to-end wall-clock **{total_s:.0f}s**
({args.reads/total_s:.0f} reads/s ingest->TSV) · AMR rows: {summary['amr_rows']}
(expected amrX x2 + amrY).

| phase | seconds | % of phase total | throughput |
|---|---|---|---|
{os.linesep.join(rows)}

Clustering share: {100.0 * clustering_s / max(phase_total, 1e-9):.1f}%
of phase time (VERDICT r2 #6 bar: <30%).

- Commit: {summary['commit'] or 'unknown (no git history)'}
- FASTQ: SHA-256 {summary['fastq_sha256']} (decompressed), {summary['fastq_bytes']:,} bytes
  of gzip, read by the {summary['fastq_path']} path; generation {files['generation_seconds']:.1f} s
  in its child{' (reused)' if files['reused'] else ''}
- Peak device memory: {peak_txt}
- Host: peak resident set {summary['host_peak_rss_bytes']:,} bytes of this process; memory total {host_txt} bytes
- sw_dp launches by (B, Lq, W): {shapes}
- k-mer counter: dense tables {summary['dense_tables']}, sorted tables {summary['sorted_tables']}
"""


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m amira_tpu_torch.scale_run",
        description="The 500,000-read ceiling run on the port (twin of scale_run.py).",
    )
    ap.add_argument("--reads", type=int, default=500_000)
    ap.add_argument(
        "--device", default="cuda",
        help="cuda, cuda:N or cpu (default cuda; no fallback to the CPU)",
    )
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--report", default=None)
    ap.add_argument(
        "--reuse", action="store_true",
        help="skip generation when the workdir already holds the isolate "
        "(generated earlier with the same --reads, by this script or scale_run.py)",
    )
    ap.add_argument(
        "--generate-only", action="store_true",
        help="generate the isolate and exit",
    )
    args = ap.parse_args(argv)

    import torch

    from . import resolve_device
    from .ops import graph_tables, kmer, sw_batch

    device = resolve_device(args.device)
    workdir = os.path.abspath(args.workdir)
    if not (args.reuse and os.path.exists(marker_path(workdir, args.reads, isolate_kwargs()))):
        sys.stderr.write(f"[scale] generating {args.reads} reads...\n")
    files = generate(workdir, args.reads, reuse=args.reuse)
    sys.stderr.write(
        f"[scale] {'reusing generated isolate' if files['reused'] else 'generated'}: "
        f"FASTQ sha256 {files['fastq_sha256']}, {files['generation_seconds']:.0f}s\n"
    )
    if args.generate_only:
        sys.stderr.write("[scale] generate-only: done\n")
        return files

    out = os.path.join(workdir, "out")
    for counts in (sw_batch.LAUNCHES, graph_tables.DEVICE_RUNS, kmer.DENSE_TABLES, kmer.SORTED_TABLES):
        for key in counts:
            counts[key] = 0
    sw_batch.DP_SHAPES.clear()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    run_cli(cli_argv(files, out, args.device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    total_s = time.time() - t0

    with open(os.path.join(out, "phase_timings.json")) as fh:
        phases = json.load(fh)
    rows = read_rows(out)
    fastq_bytes = os.path.getsize(files["fastq"])
    summary = {
        "reads": args.reads,
        "seconds": total_s,
        "reads_per_sec": args.reads / total_s,
        "platform": card_line(device),
        "device": str(device),
        "amr_rows": len(rows),
        "rows": [
            {k: r[k] for k in ("Determinant name", "Amira allele", "Closest reference",
                               "Identity (%)", "Approximate cellular copy number")}
            for r in rows
        ],
        "phases": phase_seconds(phases),
        "cleaning_stages": cleaning_stages(phases),
        "commit": commit(),
        "fastq_sha256": files["fastq_sha256"],
        "fastq_bytes": fastq_bytes,
        "fastq_path": "whole-file" if fastq_bytes <= FASTQ_WHOLE_FILE_MAX_BYTES else "streaming",
        "generation_seconds": files["generation_seconds"],
        "generation_reused": files["reused"],
        "peak_device_memory_bytes": (
            torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
        ),
        "host_peak_rss_bytes": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024,
        "host_memory_total_bytes": host_memory_total(),
        "launches": dict(sw_batch.LAUNCHES),
        "sw_dp_shapes": sorted([b, lq, w, n] for (b, lq, w), n in sw_batch.DP_SHAPES.items()),
        "dense_tables": dict(kmer.DENSE_TABLES),
        "sorted_tables": dict(kmer.SORTED_TABLES),
        "window_hash_runs": dict(graph_tables.DEVICE_RUNS),
    }
    report = args.report or os.path.join(out, "SCALE_REPORT.md")
    text = _report(args, files, summary, phases)
    print(text)
    with open(report, "w") as fh:
        fh.write(text)
    with open(os.path.join(out, "scale_summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    sys.stderr.write(
        f"[scale] done: {total_s:.0f}s e2e, {len(rows)} AMR rows, report -> {report}\n"
    )
    assert len(rows) >= 2, "expected the multi-copy AMR calls"
    return summary


if __name__ == "__main__":
    main()
