"""Synthetic E. coli isolates for the benchmark, made from a seed.

A vectorised rewrite of the repo's `tests/synthetic.make_isolate` (the
isolate) and `chip_smoke.write_sam_inputs` (pandora's SAM and consensus),
frozen here so that the yardstick does not move with the program:

- a gene-space genome: `genes` single-copy genes of `gene_len` random bases,
  with AMR genes inserted after the genes named in `amr_after`;
- `reads` long reads, each a run of `genes_per_read` consecutive genome
  slots (bounds included), every base mutated with `sub` substitutions and
  `indel` insertions and deletions (half each), `reverse_fraction` of them
  reverse-complemented;
- pandora's gene calls of each read (JSON calls and positions, or a SAM of
  every call plus the consensus of every gene), with `call_noise` of the
  non-AMR calls dropped or strand-flipped (half each);
- the species assets (each AMR gene's reference alleles: NG001, and NG002
  with 3 % substitutions from it; phenotypes; core and plasmid gene lists)
  and the truth. The isolate's own allele of each AMR gene is NG001 with
  `allele_divergence` substitutions: its closest reference is NG001, and
  polishing has to find its sequence.

Everything is drawn from one `numpy.random.Generator` seeded with `seed`,
in the sorted order of gene names, so the files do not depend on
PYTHONHASHSEED. Reads are made in blocks of `BLOCK_READS`, which bounds the
memory. The FASTQ is written with gzip at level 1, one gzip member per
block, as a sequencer's basecaller writes it in batches.
"""

from __future__ import annotations

import json
import os
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BLOCK_READS = 2048
GZIP_LEVEL = 1
GZIP_THREADS = 4
_ASCII = np.frombuffer(b"ACGT", np.uint8)


def rng_for(seed: int) -> np.random.Generator:
    """The generator of one isolate: any whole number is a seed."""
    return np.random.default_rng(seed % (1 << 64))


def genome(genes: int, amr_after: dict) -> tuple[list[str], list[str]]:
    """(slots, names): the genome's gene order, AMR genes inserted after
    the numbered genes of `amr_after` ({"amrX": [500, 2900], ...}), and
    the sorted names of its distinct genes."""
    after: dict = {}
    for g, loci in amr_after.items():
        for i in loci:
            after.setdefault(int(i), []).append(g)
    slots = []
    for i in range(genes):
        slots.append(f"gene{i}")
        slots.extend(sorted(after.get(i, [])))
    return slots, sorted(set(slots))


def _mutate(rng, codes, sub, indel, length):
    """Per base of `codes` (copies of genes of `length` bases, end to end):
    a substitution, a deletion, or an insertion after it. Returns the
    mutated bases and each gene copy's change in length."""
    r = rng.random(codes.size, dtype=np.float32)
    ev = np.flatnonzero(r < sub + indel)
    rv = r[ev]
    sub_i = ev[rv < sub]
    del_i = ev[(rv >= sub) & (rv < sub + indel / 2)]
    ins_i = ev[rv >= sub + indel / 2]
    out = codes.copy()
    out[sub_i] = (out[sub_i] + rng.integers(1, 4, sub_i.size, dtype=np.uint8)) % 4
    out = np.insert(out, ins_i + 1, rng.integers(0, 4, ins_i.size, dtype=np.uint8))
    # an insertion after base j moves every later base one on
    out = np.delete(out, del_i + np.searchsorted(ins_i, del_i))
    n = codes.size // length
    delta = np.bincount(ins_i // length, minlength=n) - np.bincount(del_i // length, minlength=n)
    return out, delta


def _block(rng, gene_codes, slot_gene, amr_mask, n, p):
    """One block of `n` reads. Returns (bases, read_len, rev, calls, genes,
    true_calls): the reads' forward bases end to end, their lengths, which
    reads are reverse-complemented, pandora's calls (read index, gene id,
    strand 0/1, start, end) in each read's own order, the gene id of every
    gene copy the reads hold, and the calls as they would be without
    pandora's noise."""
    n_slots = slot_gene.size
    lo, hi = p["genes_per_read"]
    span = np.minimum(rng.integers(lo, hi + 1, n), n_slots)
    start = rng.integers(0, n_slots - span + 1)
    inst_read = np.repeat(np.arange(n), span)
    first = np.cumsum(span) - span
    inst_slot = start[inst_read] + np.arange(inst_read.size) - first[inst_read]
    inst_gene = held = slot_gene[inst_slot]
    L = gene_codes.shape[1]
    bases, delta = _mutate(rng, gene_codes[inst_gene].ravel(), p["sub"], p["indel"], L)
    inst_len = L + delta
    inst_end = np.cumsum(inst_len)
    inst_start = inst_end - inst_len
    read_end = inst_end[first + span - 1]
    read_start = inst_start[first]
    read_len = read_end - read_start
    q0 = inst_start - read_start[inst_read]
    q1 = q0 + inst_len - 1
    rev = rng.random(n) < p["reverse_fraction"]
    # calls in each read's own order: a reversed read lists its genes backwards
    inst_rev = rev[inst_read]
    strand = inst_rev.astype(np.int8)
    c_start = np.where(inst_rev, read_len[inst_read] - 1 - q1, q0)
    c_end = np.where(inst_rev, read_len[inst_read] - 1 - q0, q1)
    order = np.arange(inst_read.size)
    pos_in = order - first[inst_read]
    order = np.where(inst_rev, first[inst_read] + span[inst_read] - 1 - pos_in, order)
    inst_gene, strand = inst_gene[order], strand[order]
    c_start, c_end = c_start[order], c_end[order]
    true_calls = (inst_read, inst_gene, strand.copy(), c_start, c_end)
    # pandora's miscalls, never on AMR genes; a read that would lose every
    # call keeps them all
    r = rng.random(inst_read.size)
    noisy = ~amr_mask[inst_gene] & (r < p["call_noise"])
    drop = noisy & (r < p["call_noise"] / 2)
    flipc = noisy & ~drop
    kept = np.bincount(inst_read, weights=~drop, minlength=n)
    drop &= kept[inst_read] > 0
    flipc &= kept[inst_read] > 0
    strand = strand ^ flipc.astype(np.int8)
    keep = ~drop
    calls = (inst_read[keep], inst_gene[keep], strand[keep], c_start[keep], c_end[keep])
    return bases, read_len, rev, calls, held, true_calls


_COMPLEMENT = bytes.maketrans(b"ACGT", b"TGCA")


def _fastq_bytes(names, bases, read_len, rev=None) -> bytes:
    """FASTQ records of reads laid end to end in `bases`; a read with `rev`
    set is written reverse-complemented."""
    text = _ASCII[bases].tobytes()
    flip = [False] * len(names) if rev is None else rev.tolist()
    parts = []
    o = 0
    for name, n, f in zip(names, read_len.tolist(), flip):
        seq = text[o : o + n]
        if f:
            seq = seq[::-1].translate(_COMPLEMENT)
        parts.append(b"@%s\n%s\n+\n%s\n" % (name, seq, b"I" * n))
        o += n
    return b"".join(parts)


def _gzip_member(data: bytes) -> bytes:
    return zlib.compress(data, GZIP_LEVEL, 31)


def _write_fastq_gz(path, chunks):
    """Writes blocks of FASTQ text as a gzip file of one member per block
    (as bgzip does), compressed by `GZIP_THREADS` threads."""
    with open(path, "wb") as f, ThreadPoolExecutor(GZIP_THREADS) as pool:
        pending = []
        for chunk in chunks:
            pending.append(pool.submit(_gzip_member, chunk))
            if len(pending) > GZIP_THREADS:
                f.write(pending.pop(0).result())
        for fut in pending:
            f.write(fut.result())


def make_isolate(out_dir: str, seed: int, params: dict) -> dict:
    """Writes one isolate into `out_dir` and returns its files and truth.

    `params` (a configuration merged with its traffic): genes, gene_len,
    amr_after, allele_divergence, reads, genes_per_read, sub, indel,
    reverse_fraction, call_noise, route ("json" or "sam")."""
    os.makedirs(out_dir, exist_ok=True)
    rng = rng_for(seed)
    slots, names = genome(int(params["genes"]), params["amr_after"])
    amr = sorted(params["amr_after"])
    gid = {g: i for i, g in enumerate(names)}
    gene_codes = rng.integers(0, 4, (len(names), int(params["gene_len"])), dtype=np.uint8)
    slot_gene = np.array([gid[g] for g in slots], np.int64)
    amr_mask = np.zeros(len(names), bool)
    amr_mask[[gid[g] for g in amr]] = True
    # each AMR gene: its reference allele NG001, the isolate's own allele
    # (NG001 with `allele_divergence` substitutions, so polishing has work)
    # and a second reference NG002 (NG001 with 3 % substitutions)
    L = gene_codes.shape[1]
    refs, variants = {}, {}
    for g in amr:
        ref = gene_codes[gid[g]].copy()
        gene_codes[gid[g]] = _mutate(rng, ref, float(params["allele_divergence"]), 0.0, L)[0]
        refs[g] = _ASCII[ref].tobytes().decode()
        variants[g] = _ASCII[_mutate(rng, ref, 0.03, 0.0, L)[0]].tobytes().decode()

    n_reads = int(params["reads"])
    calls_by_read: list = []
    true_by_read: list = []
    reads_per_gene = np.zeros(len(names), np.int64)
    fastq = os.path.join(out_dir, "reads.fastq.gz")
    read_ids = []

    def records():
        for b0 in range(0, n_reads, BLOCK_READS):
            n = min(BLOCK_READS, n_reads - b0)
            bases, read_len, rev, calls, held, true_calls = _block(
                rng, gene_codes, slot_gene, amr_mask, n, params
            )
            reads_per_gene[:] += np.bincount(held, minlength=len(names))
            ids = [b"read%d" % i for i in range(b0, b0 + n)]
            read_ids.extend(x.decode() for x in ids)
            ri, g, s, c0, c1 = calls
            calls_by_read.append((ri + b0, g, s, c0, c1))
            ri, g, s, c0, c1 = true_calls
            true_by_read.append((ri + b0, g, s, c0, c1))
            yield _fastq_bytes(ids, bases, read_len, rev)

    _write_fastq_gz(fastq, records())
    ri, g, s, c0, c1 = (np.concatenate(x) for x in zip(*calls_by_read))
    files = {"fastq": fastq, "reads": n_reads}
    offsets = np.searchsorted(ri, np.arange(n_reads + 1))
    if params["route"] == "sam":
        files.update(_write_sam(out_dir, read_ids, offsets, g, s, c0, c1, names, gene_codes))
    else:
        labels = np.array([f"{'+-'[k]}{nm}" for nm in names for k in (0, 1)], dtype=object)
        lab = labels[g * 2 + s].tolist()
        pos = np.stack([c0, c1], 1).tolist()
        calls, positions = {}, {}
        for i, rid in enumerate(read_ids):
            a, b = offsets[i], offsets[i + 1]
            calls[rid] = lab[a:b]
            positions[rid] = pos[a:b]
        files["calls"] = os.path.join(out_dir, "calls.json")
        files["positions"] = os.path.join(out_dir, "positions.json")
        with open(files["calls"], "w") as f:
            f.write(json.dumps(calls))
        with open(files["positions"], "w") as f:
            f.write(json.dumps(positions))
    files.update(_write_assets(out_dir, amr, names, refs, variants))
    truth = {
        "allele_seqs": {a: _ASCII[gene_codes[gid[a]]].tobytes().decode() for a in amr},
        "copy_counts": {a: slots.count(a) for a in amr},
        "true_allele": "NG001",
        # reads whose bases hold each gene, whatever pandora called
        "reads_per_gene": dict(zip(names, reads_per_gene.tolist())),
        "gene_names": names,
        # every read's genes without pandora's noise, in the read's own
        # order: read index, gene id, strand (1 reversed), start, end
        "calls": tuple(np.concatenate(x) for x in zip(*true_by_read)),
    }
    files["truth"] = truth
    return files


def _write_sam(out_dir, read_ids, offsets, g, s, c0, c1, names, gene_codes):
    """pandora map's output for these calls: a SAM with one record per call
    (the read region as a leading hard clip and a match) and the consensus
    of every gene."""
    sam = os.path.join(out_dir, "pandora.filtered.sam")
    L = gene_codes.shape[1]
    with open(sam, "w") as o:
        o.write("@HD\tVN:1.6\n")
        o.write("".join(f"@SQ\tSN:{nm}\tLN:{L}\n" for nm in names))
        flags = np.where(s == 1, 16, 0).tolist()
        gl, a, b = g.tolist(), c0.tolist(), c1.tolist()
        lines = []
        for i, rid in enumerate(read_ids):
            for j in range(offsets[i], offsets[i + 1]):
                clip = f"{a[j] + 1}H" if a[j] > 0 else ""
                lines.append(
                    f"{rid}\t{flags[j]}\t{names[gl[j]]}\t1\t60\t{clip}{b[j] - a[j] + 1}M\t*\t0\t0\t*\t*\n"
                )
        o.write("".join(lines))
    consensus = os.path.join(out_dir, "pandora.consensus.fq.gz")
    _write_fastq_gz(
        consensus,
        [_fastq_bytes([nm.encode() for nm in names], gene_codes.ravel(), np.full(len(names), L))],
    )
    return {"sam": sam, "consensus": consensus}


def _write_assets(out_dir, amr, names, refs, variants):
    fasta, phen = [], {}
    for g in amr:
        fasta += [f">{g};{g}.NG001.1", refs[g], f">{g};{g}.NG002.1", variants[g]]
        phen[f"{g}.NG001.1"] = f"{g} reference phenotype"
        phen[f"{g}.NG002.1"] = f"{g} variant phenotype"
    out = {
        "amr_fasta": os.path.join(out_dir, "AMR_alleles_unified.fa"),
        "amr_calls": os.path.join(out_dir, "AMR_calls.json"),
        "core_genes": os.path.join(out_dir, "core_genes.txt"),
        "plasmid_genes": os.path.join(out_dir, "plasmid_genes.txt"),
    }
    with open(out["amr_fasta"], "w") as f:
        f.write("\n".join(fasta))
    with open(out["amr_calls"], "w") as f:
        f.write(json.dumps(phen))
    with open(out["core_genes"], "w") as f:
        f.write("\n".join(n for n in names if n not in amr))
    with open(out["plasmid_genes"], "w") as f:
        f.write("")
    return out
