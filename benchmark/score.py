"""Accuracy of one isolate's answer against the generator's truth: a frozen
copy of `amira_tpu_torch/accuracy_run.score` (each row's allele identity to
its true sequence by an edit distance of its own, and copy recall and
precision). The benchmark prints it on an earlier line; it is not a metric
and does not decide `correct`."""

from __future__ import annotations

import collections
import os

import numpy as np

from reference import edit_distance, read_rows


def identity(a: str, b: str) -> float:
    if a == b:
        return 1.0
    if not a or not b:
        return 0.0
    return max(0.0, 1.0 - edit_distance(a, b) / max(len(a), len(b)))


def score(out_dir: str, truth: dict) -> dict:
    rows = []
    identities = []
    detected = collections.Counter()
    for row in read_rows(out_dir):
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
