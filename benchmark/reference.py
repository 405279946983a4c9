"""The plain reference that decides `correct`: NumPy and the standard
library only, independent of the program under test.

Amira's answer for an isolate is its `amira_results.tsv`: one row per AMR
gene copy, with the closest reference allele, the polished allele sequence
(`AMR_allele_fastqs/<allele>/06.final_sequence.fasta`) and a copy number.
The generator's truth says what that answer must be: each AMR gene as many
times as the genome holds it, NG001 as the closest reference, the
isolate's own allele sequence, a copy number of 1 for each copy, and
polishing from the reads that hold the gene. The outputs written beside
the table are judged too: the corrected gene calls against each read's
true genes, and that the GML and the allele FASTQs hold their records.
On pandora's SAM route the reference also
works out again, from the SAM and the consensus both sides read, which
gene calls the consensus QC and the gene filters keep, and the core genes'
mean read depth that the QC's alignments must give.

Each number `judge` returns that the cell's "limits" name
(`benchmark/workloads/<cell>.json`) is compared with its limit.
"""

from __future__ import annotations

import collections
import csv
import glob
import gzip
import json
import os
import re

import numpy as np

RESULTS = "amira_results.tsv"
ALLELE_FILE = "06.final_sequence.fasta"
KEPT_CALLS = "gene_calls_with_gene_filtering.json"
KEPT_POSITIONS = "gene_positions_with_gene_filtering.json"
CORRECTED_CALLS = "corrected_gene_calls.json"
CORRECTED_POSITIONS = "corrected_gene_positions.json"
GML = "gene_mer_graph*.gml"
POLISH_READS = "Number of reads used for polishing"
GML_LABEL = re.compile(r'^\s*label\s+"([^"]*)"', re.M)
DEPTH_LINE = re.compile(r"mean read depth across core genes = ([0-9]+(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?)")


def edit_distance(a: str, b: str) -> int:
    """Levenshtein distance, one NumPy row at a time."""
    av = np.frombuffer(a.encode(), np.uint8)
    bv = np.frombuffer(b.encode(), np.uint8)
    n, m = len(av), len(bv)
    if n == 0 or m == 0:
        return max(n, m)
    j = np.arange(m + 1)
    prev = j.astype(np.int64)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, np.int64)
        cur[0] = i
        cur[1:] = np.minimum(prev[1:] + 1, prev[:-1] + (av[i - 1] != bv))
        # insertions: cur[j] = min over t <= j of cur[t] + (j - t)
        prev = np.minimum.accumulate(cur - j) + j
    return int(prev[m])


def read_rows(out_dir: str) -> list[dict]:
    with open(os.path.join(out_dir, RESULTS), newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def _fasta_sequence(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path) as f:
        return "".join(line.strip() for line in f if not line.startswith(">"))


def _load_json(path: str):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _fastq_records(path: str) -> int:
    """Records of a gzipped FASTQ (-1 if it cannot be read)."""
    try:
        with gzip.open(path, "rt") as f:
            return sum(1 for i, _ in enumerate(f) if i % 4 == 0)
    except (OSError, EOFError):
        return -1


def true_reads(truth: dict) -> dict:
    """Each read's genes as pandora would call them without noise: read id
    -> (labels with their strand, [start, end] of each), in the read's own
    order."""
    ri, g, s, c0, c1 = (np.asarray(x) for x in truth["calls"])
    names = truth["gene_names"]
    labels = [("+-"[k]) + names[i] for i, k in zip(g.tolist(), s.tolist())]
    pos = np.stack([c0, c1], 1).tolist()
    bounds = np.flatnonzero(np.diff(ri)) + 1
    starts = [0] + bounds.tolist()
    ends = bounds.tolist() + [len(ri)]
    return {f"read{int(ri[a])}": (labels[a:b], pos[a:b]) for a, b in zip(starts, ends)}


def _is_run_of(calls: list, positions: list, want: tuple) -> bool:
    """Whether `calls` are a contiguous run of the read's true genes, in
    its order and with their strands, with one position a call, each
    inside the read and in the read's order. (The positions are not held
    to the true places: where cleaning puts a gene back or turns it,
    Amira gives it a stub place between its neighbours and the calls after
    it the place of the call before; only the order is exact.)"""
    labels, pos = want
    n = len(calls)
    if n == 0 or len(positions) != n:
        return False
    read_len = pos[-1][1] + 1
    starts = [p[0] for p in positions]
    if starts != sorted(starts) or any(not 0 <= a <= b < read_len for a, b in positions):
        return False
    return any(labels[k : k + n] == calls for k in range(len(labels) - n + 1))


def judge_calls(out_dir: str, truth: dict) -> int:
    """calls_wrong: reads whose corrected gene calls (the result of
    cleaning, `corrected_gene_calls.json` with its positions) are not a
    contiguous run of the read's true genes, as `_is_run_of` says. Amira
    trims each read to the genes around AMR genes, so a run, and not the
    whole read, is what a read keeps."""
    calls = _load_json(os.path.join(out_dir, CORRECTED_CALLS)) or {}
    positions = _load_json(os.path.join(out_dir, CORRECTED_POSITIONS)) or {}
    want = true_reads(truth)
    empty: tuple = ([], [])
    return sum(
        not _is_run_of(cs, positions.get(r, []), want.get(r, empty)) for r, cs in calls.items()
    )


def judge_writes(out_dir: str, truth: dict, rows: list) -> int:
    """writes_missing: outputs the pipeline writes outside its phases that
    are absent or do not hold their records: the corrected calls and
    positions (parsed, one position a call, some read holding an AMR
    gene), the gene-mer graph's GML (a node naming each AMR gene), and for
    each row its allele's FASTQ (at least as many reads as polishing used,
    and one) and its final sequence."""
    amr = set(truth["allele_seqs"])
    missing = 0
    calls = _load_json(os.path.join(out_dir, CORRECTED_CALLS))
    positions = _load_json(os.path.join(out_dir, CORRECTED_POSITIONS))
    if not isinstance(calls, dict) or not isinstance(positions, dict):
        missing += 1
    else:
        if set(calls) != set(positions) or any(len(positions[r]) != len(c) for r, c in calls.items()):
            missing += 1
        if not any(x[1:] in amr for c in calls.values() for x in c):
            missing += 1
    gml = glob.glob(os.path.join(out_dir, GML))
    if len(gml) != 1:
        missing += 1
    else:
        with open(gml[0]) as f:
            genes = {x[1:] for label in GML_LABEL.findall(f.read()) for x in label.split("~~~")}
        missing += len(amr - genes)
    for r in rows:
        d = os.path.join(out_dir, "AMR_allele_fastqs", r["Amira allele"])
        n = _fastq_records(os.path.join(d, r["Amira allele"] + ".fastq.gz"))
        try:
            used = int(r[POLISH_READS])
        except ValueError:
            used = n + 1
        missing += n < max(used, 1)
        missing += not os.path.exists(os.path.join(d, ALLELE_FILE))
    return missing


def judge(out_dir: str, truth: dict) -> dict:
    """The numbers of one isolate's answer against the truth (the cell's
    "limits" say which are compared):

    - copies_missing: AMR gene copies of the genome without a row;
    - copies_extra: rows beyond the genome's copies of their gene (Amira
      splits one copy's reads into two paths on some isolates, as the
      algorithm does, so its limit leaves room for a split);
    - rows_repeated: rows that repeat an earlier row's Amira allele;
    - refs_off: rows whose closest reference is not the true one;
    - allele_edits: the largest edit distance of a row's allele sequence
      from the isolate's own sequence of its gene;
    - copy_number_gap: the largest distance of a row's copy number from 1;
    - polish_reads_short: the largest share, over AMR genes, of the reads
      that hold the gene by which the reads its rows were polished from
      (the aligner's mapped reads) fall short of them;
    - calls_wrong, writes_missing: as `judge_calls` and `judge_writes`.
    """
    rows = read_rows(out_dir)
    copies = truth["copy_counts"]
    found = collections.Counter(r["Determinant name"] for r in rows)
    missing = sum(max(n - found.get(g, 0), 0) for g, n in copies.items())
    extra = sum(max(n - copies.get(g, 0), 0) for g, n in found.items())
    refs_off = sum(r["Closest reference"] != truth["true_allele"] for r in rows)
    edits, gaps = [0], [0.0]
    used: collections.Counter = collections.Counter()
    for r in rows:
        true_seq = truth["allele_seqs"].get(r["Determinant name"], "")
        seq = _fasta_sequence(os.path.join(out_dir, "AMR_allele_fastqs", r["Amira allele"], ALLELE_FILE))
        edits.append(edit_distance(seq, true_seq) if true_seq else len(seq))
        try:
            gaps.append(abs(float(r["Approximate cellular copy number"]) - 1.0))
        except ValueError:
            gaps.append(float("inf"))
        try:
            used[r["Determinant name"]] += int(r[POLISH_READS])
        except ValueError:
            used[r["Determinant name"]] += 0
    held = truth["reads_per_gene"]
    short = max(max(held[g] - used.get(g, 0), 0) / held[g] for g in copies)
    alleles = [r["Amira allele"] for r in rows]
    return {
        "copies_missing": missing,
        "copies_extra": extra,
        "rows_repeated": len(alleles) - len(set(alleles)),
        "refs_off": refs_off,
        "allele_edits": max(edits),
        "copy_number_gap": max(gaps),
        "polish_reads_short": short,
        "calls_wrong": judge_calls(out_dir, truth),
        "writes_missing": judge_writes(out_dir, truth, rows),
    }


# ------------------------------------------------------------ SAM route


def _sam_calls(sam_path: str):
    """(read, strand sign, gene, region start, region length) of each mapped
    record, in file order. The region starts one before the leading hard
    clip's length, as pandora's reader in Amira takes it."""
    with open(sam_path) as f:
        for line in f:
            if line.startswith("@"):
                continue
            qname, flag, rname, _pos, _mapq, cigar = line.split("\t", 6)[:6]
            flag = int(flag)
            if flag & 4:
                continue
            ops = re.findall(r"(\d+)([MIDNSHP=X])", cigar)
            start = int(ops[0][0]) - 1 if ops and ops[0][1] == "H" else 0
            length = sum(int(n) for n, op in ops if op != "H")
            yield qname, "-" if flag & 16 else "+", rname, start, length


def expected_sam_calls(sam_path, gene_len, amr_genes, reads_per_gene, defaults):
    """The calls and positions the SAM route keeps, by read.

    The QC drops a non-AMR consensus gene when over 20 % of its bases have
    no aligned read; a gene that some read holds whole is covered, so the
    kept genes are the AMR genes and those the truth puts in a read. A call
    stays when its gene is an AMR gene, or is kept and its region is within
    the length proportions of the gene; then every gene called less often
    than `gene_min_coverage` times the mean count of called genes goes."""
    lo = defaults["lower_gene_length_threshold"] * gene_len
    hi = defaults["upper_gene_length_threshold"] * gene_len
    calls: dict = {}
    counts: collections.Counter = collections.Counter()
    for read, sign, gene, start, length in _sam_calls(sam_path):
        if gene in amr_genes or (reads_per_gene.get(gene, 0) > 0 and lo <= length <= hi):
            calls.setdefault(read, []).append((sign + gene, [start, start + length - 1]))
            counts[gene] += 1
    least = float(np.mean(list(counts.values()))) * defaults["gene_min_coverage"] if counts else 0
    return {
        r: [c for c in cs if counts[c[0][1:]] >= least] for r, cs in calls.items()
    }


def judge_sam(out_dir, files, truth, params, program_stderr: str) -> dict:
    """The SAM route's own numbers:

    - calls_off: reads whose kept calls or positions differ from the
      reference's, or that only one side has;
    - qc_depth_gap: the relative distance of the core genes' mean read
      depth the program reports from the truth's, the mean over core genes
      that some read holds of the number of reads that hold them (the QC
      aligns every read to every consensus gene)."""
    amr = set(truth["allele_seqs"])
    expected = expected_sam_calls(
        files["sam"], int(params["gene_len"]), amr, truth["reads_per_gene"], params["defaults"]
    )
    with open(os.path.join(out_dir, KEPT_CALLS)) as f:
        got_calls = json.load(f)
    with open(os.path.join(out_dir, KEPT_POSITIONS)) as f:
        got_pos = json.load(f)
    off = 0
    for r in set(expected) | set(got_calls):
        want = expected.get(r)
        got = list(zip(got_calls.get(r, []), got_pos.get(r, [])))
        if want is None or [(g, list(p)) for g, p in got] != want:
            off += 1
    held = [n for g, n in truth["reads_per_gene"].items() if g not in amr and n > 0]
    want_depth = float(np.mean(held))
    found = DEPTH_LINE.findall(program_stderr)
    depth = float(found[-1]) if found else 0.0
    return {"calls_off": off, "qc_depth_gap": abs(depth - want_depth) / want_depth}
