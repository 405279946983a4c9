"""The generator: the same seed gives the same files whatever
PYTHONHASHSEED is, and the files hold what the parameters ask for."""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, TINY

import generate
import spec
from reference import edit_distance, true_reads

SCRIPT = """
import json, sys
sys.path.insert(0, {bench!r})
import generate, spec
_entry, params = spec.cell({cell!r})
params.update(json.loads({tiny!r}))
generate.make_isolate({out!r}, 2**31 + 12345, params)
"""


def _digests(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            data = f.read()
        if name.endswith(".gz"):
            data = gzip.decompress(data)
        out[name] = hashlib.sha256(data).hexdigest()
    return out


@pytest.mark.parametrize("cell", ["ecoli_calls.noisy50k", "ecoli_sam.noisy10k"])
def test_same_seed_same_files_under_any_hash_seed(tmp_path, cell):
    digests = []
    for hash_seed in ("1", "2"):
        out = str(tmp_path / f"h{hash_seed}")
        code = SCRIPT.format(bench=str(BENCH), cell=cell, tiny=json.dumps(TINY), out=out)
        env = dict(os.environ, PYTHONHASHSEED=hash_seed)
        subprocess.run([sys.executable, "-c", code], check=True, env=env, timeout=120)
        digests.append(_digests(out))
    assert digests[0] == digests[1]


def _fastq(path):
    with gzip.open(path, "rt") as f:
        lines = f.read().split("\n")
    return {lines[i][1:]: lines[i + 1] for i in range(0, len(lines) - 1, 4)}


def _revcomp(s):
    return s.translate(str.maketrans("ACGT", "TGCA"))[::-1]


@pytest.mark.parametrize("cell", ["ecoli_calls.noisy50k", "ecoli_sam.noisy10k"])
def test_counts_follow_the_cells_parameters(tmp_path, cell):
    _entry, params = spec.cell(cell)
    params.update(TINY, reads=500)
    files = generate.make_isolate(str(tmp_path), 7, params)
    reads = _fastq(files["fastq"])
    assert len(reads) == 500
    lo, hi = params["genes_per_read"]
    slots, names = generate.genome(params["genes"], params["amr_after"])
    truth = files["truth"]
    held = sum(truth["reads_per_gene"].values())
    assert 500 * lo <= held <= 500 * hi
    assert truth["copy_counts"] == {"amrX": 2, "amrY": 1}
    L = params["gene_len"]
    for seq in reads.values():
        # each gene copy changes length only by its indels
        assert lo * L * (1 - params["indel"]) * 0.8 <= len(seq) <= hi * L * (1 + params["indel"]) * 1.2
    if params["route"] == "sam":
        with open(files["sam"]) as f:
            records = [ln.split("\t") for ln in f if not ln.startswith("@")]
        calls = {}
        for r in records:
            calls.setdefault(r[0], []).append(r)
        assert set(calls) == set(reads)
        with gzip.open(files["consensus"], "rt") as f:
            assert f.read().count("\n@") + 1 == len(names)
    else:
        with open(files["calls"]) as f:
            calls = json.load(f)
        with open(files["positions"]) as f:
            positions = json.load(f)
        assert set(calls) == set(reads)
        n_calls = sum(len(v) for v in calls.values())
        assert n_calls <= held
        # every AMR call's region is its gene, read on the called strand
        for rid, genes in calls.items():
            for g, (a, b) in zip(genes, positions[rid]):
                if g[1:] in truth["allele_seqs"]:
                    region = reads[rid][a : b + 1]
                    region = region if g[0] == "+" else _revcomp(region)
                    # read errors only: far from the ~half of an unrelated sequence
                    assert edit_distance(region, truth["allele_seqs"][g[1:]]) < 0.15 * L, (rid, g)
        # every call is one of the read's true genes, at its true place;
        # only its strand may be flipped, never an AMR gene's
        true = true_reads(truth)
        assert set(true) == set(reads)
        assert sum(len(v[0]) for v in true.values()) == held
        for rid, genes in calls.items():
            want = dict(zip(map(tuple, true[rid][1]), true[rid][0]))
            for g, p in zip(genes, positions[rid]):
                assert want[tuple(p)][1:] == g[1:], (rid, g, p)
                if g[1:] in truth["allele_seqs"]:
                    assert want[tuple(p)] == g, (rid, g, p)
