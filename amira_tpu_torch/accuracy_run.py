"""Allele-recovery accuracy of the port against the simulator's truth:
`python -m amira_tpu_torch.accuracy_run`.

Twin of the repo's `accuracy_run.py`, which drives the JAX package. It runs
the port's whole pipeline on a synthetic isolate with known truth (the
scale isolate's genome, amrX at two loci + amrY, seed 23, configurable
sub/indel read error) and measures:

  - each recovered allele's nucleotide identity against its TRUE sequence,
    by an edit distance of its own (not the pipeline's aligner);
  - copy-number recall and precision: the AMR rows against the genome's
    copies (amrX x2 + amrY x1).

    python -m amira_tpu_torch.accuracy_run [--reads 20000] [--sub 0.02]
        [--indel 0.01] [--device cuda] [--workdir DIR]

`--device` takes cuda, cuda:N or cpu (default cuda; without CUDA it raises).
The isolate and the pipeline's output go under `--workdir` (default
`chip_work/accuracy_run/` in the checkout). Prints a markdown table and, as
its last line, one JSON object with accuracy_run.py's keys plus the card's
name and power limit. The isolate is generated by `scale_run.generate` (a
child process with PYTHONHASHSEED=0).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np

from . import scale_run

DEFAULT_WORKDIR = os.path.join(scale_run.ROOT, "chip_work", "accuracy_run")


def isolate_params(sub: float = 0.02, indel: float = 0.01) -> dict:
    """`scale_run.generate`'s extra arguments for the accuracy isolate:
    accuracy_run.py's seed 23 and its base error rates."""
    return dict(seed=23, sub=sub, indel=indel)


def edit_distance(a: str, b: str) -> int:
    """Plain O(nm) Levenshtein with numpy rows (alleles are ~hundreds of
    bases; exactness beats the banded version's complexity here)."""
    av = np.frombuffer(a.encode(), np.uint8)
    bv = np.frombuffer(b.encode(), np.uint8)
    n, m = len(av), len(bv)
    if n == 0:
        return m
    if m == 0:
        return n
    prev = np.arange(m + 1, dtype=np.int32)
    for i in range(1, n + 1):
        cost = (av[i - 1] != bv).astype(np.int32)
        cur = np.empty(m + 1, np.int32)
        cur[0] = i
        # substitution/deletion are vectorizable; insertion is a prefix
        # min-scan: cur[j] = min(base[j], min_{t<j}(cur[t] + j - t))
        base = np.minimum(prev[1:] + 1, prev[:-1] + cost)
        cur[1:] = base
        run = np.minimum.accumulate(cur - np.arange(m + 1))
        cur = np.minimum(cur, run + np.arange(m + 1))
        prev = cur
    return int(prev[m])


def identity(a: str, b: str) -> float:
    if a == b:
        return 1.0
    if not a or not b:
        return 0.0
    return max(0.0, 1.0 - edit_distance(a, b) / max(len(a), len(b)))


def score(out_dir: str, truth: dict) -> dict:
    """The accuracy of one run's output directory against the isolate's
    truth (`truth.json`'s dict): each row's recovered allele (its
    06.final_sequence.fasta, else 03.sequence_to_polish.fasta) against the
    true sequence, and the rows' copy recall and precision."""
    rows = []
    identities = []
    detected = collections.Counter()
    for row in scale_run.read_rows(out_dir):
        gene = row["Determinant name"]
        allele = row["Amira allele"]
        detected[gene] += 1
        seq = None
        for name in ("06.final_sequence.fasta", "03.sequence_to_polish.fasta"):
            p = os.path.join(out_dir, "AMR_allele_fastqs", allele, name)
            if os.path.exists(p):
                with open(p) as fh:
                    seq = "".join(fh.read().split("\n")[1:]).strip()
                break
        true_seq = truth["allele_seqs"].get(gene)
        ident = identity(seq or "", true_seq or "")
        identities.append(ident)
        rows.append((allele, gene, len(seq or ""), len(true_seq or ""), 100.0 * ident))
    copies = truth["copy_counts"]
    tp = sum(min(detected.get(g, 0), c) for g, c in copies.items())
    fn = sum(max(c - detected.get(g, 0), 0) for g, c in copies.items())
    fp = sum(max(n - copies.get(g, 0), 0) for g, n in detected.items())
    return {
        "rows": rows,
        "mean_identity": float(np.mean(identities)) if identities else 0.0,
        "copy_recall": tp / max(tp + fn, 1),
        "copy_precision": tp / max(tp + fp, 1),
        "tp": tp,
        "fn": fn,
        "fp": fp,
    }


def evaluate(files: dict, out: str, device: str, sub: float, indel: float) -> dict:
    """Runs the port's CLI on a generated isolate (`scale_run.generate`'s
    dict) on `device`, into `out`, scores it against the isolate's truth and
    prints accuracy_run.py's table and JSON line. Returns that line's values
    plus the table's rows and `out`."""
    from . import resolve_device

    dev = resolve_device(device)
    with open(files["truth"]) as fh:
        truth = json.load(fh)
    t0 = time.time()
    scale_run.run_cli(scale_run.cli_argv(files, out, device) + ["--quiet"])
    wall = time.time() - t0
    result = score(out, truth)

    reads = files["n_reads"]
    platform = "gpu" if dev.type == "cuda" else dev.type
    card, _, power_limit = scale_run.card_line(dev).rpartition(", ")
    tp, fn, fp = result["tp"], result["fn"], result["fp"]
    print(f"\n## Allele-recovery accuracy ({reads:,} reads, "
          f"{100 * sub:.0f}%/{100 * indel:.0f}% sub/indel, "
          f"{platform}, {wall:.0f}s)\n")
    print("| Amira allele | gene | recovered len | truth len | identity vs truth |")
    print("|---|---|---|---|---|")
    for allele, gene, ls, lt, ident in result["rows"]:
        print(f"| {allele} | {gene} | {ls} | {lt} | {ident:.2f}% |")
    print(f"\nMean recovered-allele identity: **{100 * result['mean_identity']:.2f}%** · "
          f"copy recall **{100 * result['copy_recall']:.1f}%** ({tp}/{tp + fn}) · "
          f"copy precision **{100 * result['copy_precision']:.1f}%** ({tp}/{tp + fp})")
    line = {
        "metric": "allele_recovery_identity_pct",
        "value": round(100 * result["mean_identity"], 2),
        "unit": "%",
        "copy_recall": round(result["copy_recall"], 4),
        "copy_precision": round(result["copy_precision"], 4),
        "reads": reads,
        "sub": sub,
        "indel": indel,
        "platform": platform,
        "card": card or power_limit,
        "power_limit": power_limit if card else None,
        "seconds": wall,
        "fastq_sha256": files["fastq_sha256"],
    }
    print(json.dumps(line))
    return {**line, "rows": result["rows"], "out": out}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m amira_tpu_torch.accuracy_run",
        description="Allele-recovery accuracy of the port against truth (twin of accuracy_run.py).",
    )
    ap.add_argument("--reads", type=int, default=20000)
    ap.add_argument("--sub", type=float, default=0.02)
    ap.add_argument("--indel", type=float, default=0.01)
    ap.add_argument(
        "--device", default="cuda",
        help="cuda, cuda:N or cpu (default cuda; no fallback to the CPU)",
    )
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    args = ap.parse_args(argv)

    from . import resolve_device

    resolve_device(args.device)  # before a generation that would be wasted
    workdir = os.path.abspath(args.workdir)
    files = scale_run.generate(workdir, args.reads, **isolate_params(args.sub, args.indel))
    return evaluate(files, os.path.join(workdir, "out"), args.device, args.sub, args.indel)


if __name__ == "__main__":
    main()
