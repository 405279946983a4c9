"""Banded two-piece-affine local alignment (minimap2 replacement).

Port of `amira_tpu/ops/align.py`. The reference shells out to minimap2
(`-a --MD -x map-ont --eqx`, result_utils.py:259-276) for read->allele and
allele->allele alignment. Here each batch of alignment jobs runs the banded
DP and its traceback as two hand-written CUDA kernels on the GPU
(`ops/sw_batch.py`, `csrc/sw_batch.cu`), or their plain PyTorch versions on
the CPU: M/I/D/I2/D2 band vectors with two-piece affine gaps (minimap2's
-O 4,24 -E 2,1), traceback directions packed one byte per cell, and the walk
emitting 2-bit-packed =/X/I/D op sequences (minimap2 --eqx semantics).

Band placement is seed-chain-extend, with the JAX package's jobs:
shared-15-mer hits are clustered by diagonal into chains, the top chains
each get a banded extension, z-drop (minimap2 -z) splits alignments across
bad joins, and collinear chain pieces are stitched back together
with two-piece gap costs, so a read with a structural gap wider than the
band still maps as one alignment with a long I/D run. Pairs with no seeds
are reported unmapped. Seeding and chaining run on the aligner's device
(the card, or the CPU): one seed index over every reference, and all reads
of a `map_reads` call seeded together in a few passes of sorts and
searches (at most `SEED_PASS_BASES` query bases and `SEED_PASS_HITS` hits
a pass), of which only the job table comes back to the host.

Under an open phase (`tracing`), each `map_reads` is divided into spans:
`align.seed` (the seed chains; it counts the device `seed_passes`, the
query `seed_kmers` of both strands, the `seed_hits` kept after the repeat
cut and the reads' reference subsets, and the `seed_jobs` emitted, which
the batches' `jobs` add up to), then per batch `align.pack` (the job
arrays), `align.kernels` (the DP and traceback and the copies back, the
host waiting for the card) and `align.unpack` (the CIGARs), and last
`align.stitch` (z-drop split and stitch; `map_with_diagonals` has the
batches and the stitch). A job carries only the query rows its band can
reach (`_run_jobs`). `align.kernels` counts the batch's `launches` (one
`sw_cigar`: one sw_dp and one sw_traceback launch), `jobs`, `rows_full`
(the jobs' whole query lengths), `rows_kept` (the query rows sent),
`live_cells` (rows sent x band width, the DP's cells) and `tb_steps`
(the traceback walks' steps), from host arrays the batch holds.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..sketch import encode_dna
from ..tracing import TIMER

NEG = -(2**28)

# ONT-style scoring (minimap2 map-ont: A=2, B=4, O=4,24, E=2,1, z=400)
MATCH = 2
MISMATCH = -4
GAP_OPEN = 6  # first gap base, short piece: O1 + E1
GAP_EXT = 2
GAP_OPEN2 = 25  # first gap base, long piece: O2 + E2
GAP_EXT2 = 1
ZDROP = 400


def gap_cost(g: int) -> int:
    """Two-piece affine cost of a gap of length g (minimap2 semantics)."""
    if g <= 0:
        return 0
    return min(GAP_OPEN + (g - 1) * GAP_EXT, GAP_OPEN2 + (g - 1) * GAP_EXT2)


# CIGAR letters of the traceback's 2-bit op codes (ops/sw_batch.OP_*)
_OPS_STR = "=XID"


def _unpack_cigar(packed_row: np.ndarray, n: int):
    """Host: 2-bit unpack + run-length encode one job's op sequence into
    [(op, len), ...] cigar tuples (ops arrive back-to-front)."""
    if n <= 0:
        return []
    nbytes = (n + 3) // 4
    b = packed_row[:nbytes].astype(np.uint8)
    ops = np.empty(nbytes * 4, dtype=np.uint8)
    ops[0::4] = b & 3
    ops[1::4] = (b >> 2) & 3
    ops[2::4] = (b >> 4) & 3
    ops[3::4] = (b >> 6) & 3
    ops = ops[:n][::-1]
    change = np.flatnonzero(ops[1:] != ops[:-1])
    starts = np.concatenate([[0], change + 1])
    ends = np.concatenate([change + 1, [n]])
    return [
        (_OPS_STR[ops[s]], int(e - s)) for s, e in zip(starts, ends)
    ]


@dataclass
class Alignment:
    """A local alignment of query against ref (one SAM record equivalent)."""

    q_start: int
    q_end: int  # exclusive
    r_start: int
    r_end: int  # exclusive
    score: int
    cigar: list  # [(op, length)] with ops in "=XID"
    q_len: int
    r_len: int

    @property
    def matching_bases(self) -> int:
        return sum(n for op, n in self.cigar if op == "=")

    @property
    def aligned_ref_positions(self):
        return (self.r_start, self.r_end)

    def cigar_string(self, with_clips=True) -> str:
        parts = []
        if with_clips and self.q_start > 0:
            parts.append(f"{self.q_start}S")
        parts.extend(f"{n}{op}" for op, n in self.cigar)
        if with_clips and self.q_len - self.q_end > 0:
            parts.append(f"{self.q_len - self.q_end}S")
        return "".join(parts)

    def cigar_tuples(self, with_clips=True):
        """pysam-style (op_code, length) tuples: = ->7, X->8, I->1, D->2, S->4."""
        code = {"=": 7, "X": 8, "I": 1, "D": 2}
        out = []
        if with_clips and self.q_start > 0:
            out.append((4, self.q_start))
        out.extend((code[op], n) for op, n in self.cigar)
        if with_clips and self.q_len - self.q_end > 0:
            out.append((4, self.q_len - self.q_end))
        return out

    def identity(self) -> float:
        """matching / (aligned cols excluding clips), minimap2 --eqx style."""
        total = sum(n for _, n in self.cigar)
        return self.matching_bases / total if total else 0.0


_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def reverse_complement(seq: str) -> str:
    return seq.translate(_COMP)[::-1]


_KMER_SENTINEL = np.uint64(1) << np.uint64(62)


def query_seed_kmers(qcodes: np.ndarray, k: int = 15):
    """One query's valid forward k-mers + their positions (the per-query
    half of seed chaining, extracted once per strand)."""
    qk = _forward_kmers(qcodes, k)
    qpos = np.nonzero(qk != _KMER_SENTINEL)[0]
    return qk[qpos], qpos


def _forward_kmers(codes: np.ndarray, k: int) -> np.ndarray:
    """Forward-strand packed k-mers (invalid windows -> sentinel removed)."""
    n = len(codes) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint64)
    acc = np.zeros(n, dtype=np.uint64)
    valid = np.ones(n, dtype=bool)
    for j in range(k):
        b = codes[j : j + n]
        valid &= b != 255
        acc = (acc << np.uint64(2)) | (b.astype(np.uint64) & np.uint64(3))
    return np.where(valid, acc, np.uint64(1) << np.uint64(62))


def build_ref_seed_index(rcodes: np.ndarray, k: int = 15):
    """Sorted (kmer, position) arrays for seed lookup."""
    rk = _forward_kmers(rcodes, k)
    pos = np.nonzero(rk != _KMER_SENTINEL)[0].astype(np.int64)
    rk = rk[pos]
    order = np.argsort(rk, kind="stable")
    return rk[order], pos[order]




def _bucket(n: int, minimum: int = 64) -> int:
    """Query-length bucket: the next power of two, refined to quarter steps
    (the JAX package's CPU-backend ladder, used here on every device: the
    port has no compile cost per shape, and the bucket feeds the band
    clamp in `_run_jobs`, so this keeps alignments equal to the JAX
    package run on the CPU)."""
    b = minimum
    while b < n:
        b *= 2
    if b > minimum:
        step = b // 4
        return ((n + step - 1) // step) * step
    return b


def _cigar_score(cigar) -> int:
    """Exact two-piece-affine score of a cigar. Maximal I/D runs in a
    traceback always live in one gap piece (I and D runs are separated by at
    least one M op), so per-run gap_cost reproduces the DP's score."""
    score = 0
    for op, n in cigar:
        if op == "=":
            score += MATCH * n
        elif op == "X":
            score += MISMATCH * n
        else:
            score -= gap_cost(n)
    return score


def _push_op(cigar, op, n):
    if n <= 0:
        return
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + n)
    else:
        cigar.append((op, n))


def _piece_from_ops(aln, cum, s, e):
    """Sub-alignment of aln covering op-boundary range [s, e), with leading/
    trailing gap ops stripped so pieces start and end on aligned columns."""
    cigar = list(aln.cigar[s:e])
    q0 = aln.q_start + cum[s][0]
    r0 = aln.r_start + cum[s][1]
    q1 = aln.q_start + cum[e][0]
    r1 = aln.r_start + cum[e][1]
    while cigar and cigar[0][0] in "ID":
        op, n = cigar.pop(0)
        if op == "I":
            q0 += n
        else:
            r0 += n
    while cigar and cigar[-1][0] in "ID":
        op, n = cigar.pop()
        if op == "I":
            q1 -= n
        else:
            r1 -= n
    if not cigar:
        return None
    score = _cigar_score(cigar)
    if score <= 0:
        return None
    return Alignment(
        q_start=q0, q_end=q1, r_start=r0, r_end=r1,
        score=score, cigar=cigar, q_len=aln.q_len, r_len=aln.r_len,
    )


def _zdrop_split(aln, z=ZDROP):
    """Split an alignment wherever the running score falls more than z below
    its running maximum (minimap2 -z): each kept piece ends at a running-max
    boundary and the next piece restarts at the following score minimum, so
    a bad join between two good blocks becomes two clean pieces (which the
    stitcher may rejoin with an explicit long gap instead)."""
    n_ops = len(aln.cigar)
    if n_ops <= 1:
        return [aln]
    cum = [(0, 0, 0)]
    q = r = sc = 0
    for op, n in aln.cigar:
        if op == "=":
            sc += MATCH * n
            q += n
            r += n
        elif op == "X":
            sc += MISMATCH * n
            q += n
            r += n
        elif op == "I":
            sc -= gap_cost(n)
            q += n
        else:
            sc -= gap_cost(n)
            r += n
        cum.append((q, r, sc))
    pieces = []
    s = 0
    split_any = False
    while s < n_ops:
        max_b, max_rel = s, 0
        cut = False
        b = s
        for b in range(s + 1, n_ops + 1):
            rel = cum[b][2] - cum[s][2]
            if rel > max_rel:
                max_rel, max_b = rel, b
            elif max_rel - rel > z:
                cut = True
                break
        end = max_b if max_rel > 0 else s
        if end > s:
            piece = _piece_from_ops(aln, cum, s, end)
            if piece is not None:
                pieces.append(piece)
        if not cut:
            break
        split_any = True
        # restart at the score minimum after the kept piece
        min_b, min_sc = end, cum[end][2]
        for b2 in range(end + 1, n_ops + 1):
            if cum[b2][2] < min_sc:
                min_sc, min_b = cum[b2][2], b2
        if min_b >= n_ops:
            break
        s = min_b
    if not split_any:
        return [aln]
    return pieces


def _trim_head(aln, q_min, r_min):
    """Trim leading cigar ops until the alignment starts at or after
    (q_min, r_min) in both coordinates; None if nothing usable remains."""
    q, r = aln.q_start, aln.r_start
    if q >= q_min and r >= r_min:
        return aln
    cigar = [list(c) for c in aln.cigar]
    idx = 0
    while idx < len(cigar) and (q < q_min or r < r_min):
        op, n = cigar[idx]
        if op in "=X":
            need = max(q_min - q, r_min - r)
            take = min(n, need)
            q += take
            r += take
            if take == n:
                idx += 1
            else:
                cigar[idx][1] = n - take
                break
        else:
            if op == "I":
                q += n
            else:
                r += n
            idx += 1
    rest = cigar[idx:]
    while rest and rest[0][0] in "ID":
        op, n = rest.pop(0)
        if op == "I":
            q += n
        else:
            r += n
    if not rest or q >= aln.q_end or r >= aln.r_end:
        return None
    rest = [tuple(c) for c in rest]
    score = _cigar_score(rest)
    if score <= 0:
        return None
    return Alignment(
        q_start=q, q_end=aln.q_end, r_start=r, r_end=aln.r_end,
        score=score, cigar=rest, q_len=aln.q_len, r_len=aln.r_len,
    )


def _try_merge(a, b):
    """Join two collinear pieces of the same (query, ref, strand) with
    explicit two-piece gap costs; None unless the join beats both parts
    (minimap2's long-gap patching between adjacent chains)."""
    if (b.q_start, b.r_start) < (a.q_start, a.r_start):
        a, b = b, a
    b2 = _trim_head(b, a.q_end, a.r_end)
    if b2 is None:
        return None
    q_gap = b2.q_start - a.q_end
    r_gap = b2.r_start - a.r_end
    sa = _cigar_score(a.cigar)
    joined = sa + b2.score - gap_cost(q_gap) - gap_cost(r_gap)
    if joined <= max(sa, _cigar_score(b.cigar)):
        return None
    cigar = list(a.cigar)
    _push_op(cigar, "I", q_gap)
    _push_op(cigar, "D", r_gap)
    for op, n in b2.cigar:
        _push_op(cigar, op, n)
    return Alignment(
        q_start=a.q_start, q_end=b2.q_end,
        r_start=a.r_start, r_end=b2.r_end,
        score=joined, cigar=cigar, q_len=a.q_len, r_len=a.r_len,
    )


def _stitch_pieces(pieces):
    """Greedily merge collinear alignment pieces (from separate chain bands
    or z-drop splits) until no join improves the score; returns the single
    best resulting alignment."""
    uniq = {}
    for p in pieces:
        uniq[(p.q_start, p.q_end, p.r_start, p.r_end, tuple(p.cigar))] = p
    parts = sorted(uniq.values(), key=lambda x: (x.q_start, x.r_start))
    while len(parts) > 1:
        best = None
        for x in range(len(parts)):
            for y in range(x + 1, len(parts)):
                m = _try_merge(parts[x], parts[y])
                if m is not None and (best is None or m.score > best[0].score):
                    best = (m, x, y)
        if best is None:
            break
        m, x, y = best
        parts = [p for i, p in enumerate(parts) if i not in (x, y)]
        parts.append(m)
        parts.sort(key=lambda a: (a.q_start, a.r_start))
    return max(parts, key=lambda a: a.score)


# a device pass of the seeding holds both strands' k-mers of at most
# SEED_PASS_BASES query bases, and the hits of at most SEED_PASS_HITS of
# them (~80 bytes a hit) unless one read alone has more; reads are
# independent, so where a pass ends changes no job
SEED_PASS_BASES = 1 << 24
SEED_PASS_HITS = 1 << 25


def _passes(sizes, cap):
    """(i, j) ranges of consecutive items whose `sizes` add up to at most
    `cap` a range (an item larger than `cap` alone)."""
    i = 0
    while i < len(sizes):
        j, total = i + 1, sizes[i]
        while j < len(sizes) and total + sizes[j] <= cap:
            total += sizes[j]
            j += 1
        yield i, j
        i = j


def _valid_windows(codes: np.ndarray, lens: np.ndarray, k: int, device):
    """Every window of k ACGT bases inside one of the sequences whose base
    codes (`encode_dna`, 255 for other characters) lie back to back in
    `codes`, `lens[i]` bases each, uploaded in one copy. Returns int64
    device tensors, windows in order: the sequence's index, the window's
    position in it, its forward k-mer and the k-mer of its reverse
    complement, both packed two bits a base, first base highest."""
    n = len(codes) - k + 1
    if n <= 0:
        empty = torch.zeros(0, dtype=torch.int64, device=device)
        return empty, empty, empty, empty
    c = torch.from_numpy(codes).to(device).to(torch.int64)
    lens_t = torch.from_numpy(lens).to(device)
    seq = torch.repeat_interleave(
        torch.arange(len(lens), device=device), lens_t, output_size=len(codes)
    )[:n]
    pos = torch.arange(n, device=device) - (torch.cumsum(lens_t, 0) - lens_t)[seq]
    bad = torch.zeros(len(codes) + 1, dtype=torch.int32, device=device)
    bad[1:] = torch.cumsum(c == 255, 0)
    ok = (bad[k:] - bad[:n] == 0) & (pos + k <= lens_t[seq])
    fwd = torch.zeros(n, dtype=torch.int64, device=device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        b = c[j : j + n] & 3
        fwd = (fwd << 2) | b
        rev |= (3 - b) << (2 * j)
    at = torch.nonzero(ok).squeeze(1)
    return seq[at], pos[at], fwd[at], rev[at]


class _SeedIndex:
    """One seed index over every reference, on the aligner's device: each
    valid k-mer of each reference as (k-mer, reference id, position),
    sorted in that order. A query's k-mers find their hits on all
    references at once (the JAX package searches each reference's own
    index in turn): a k-mer's hits are the run of equal entries that
    `torch.searchsorted` bounds. A k-mer seen more than `max_occ` times in
    one reference (a repeat) is left out for that reference: a query k-mer
    equal to it would hit every copy, and chaining drops such runs of hits
    (the JAX package's `_seed_chains` drops them per query k-mer)."""

    __slots__ = ("kmers", "ref", "pos")

    def __init__(self, codes: list, k: int, device, max_occ: int = 8):
        lens = np.array([len(c) for c in codes], dtype=np.int64)
        cat = np.concatenate(codes) if codes else np.zeros(0, dtype=np.uint8)
        ref, pos, fwd, _rev = _valid_windows(cat, lens, k, device)
        # stable: equal k-mers stay in (reference, position) order
        kmers, order = torch.sort(fwd, stable=True)
        ref, pos = ref[order], pos[order]
        run = torch.cumsum(_starts(kmers) | _starts(ref), 0) - 1
        keep = torch.nonzero(torch.bincount(run)[run] <= max_occ).squeeze(1)
        self.kmers, self.ref, self.pos = kmers[keep], ref[keep], pos[keep]


def _starts(key: torch.Tensor) -> torch.Tensor:
    """Bool: where a run of equal values of `key` begins."""
    first = torch.ones(len(key), dtype=torch.bool, device=key.device)
    first[1:] = key[1:] != key[:-1]
    return first


class Aligner:
    """Batched seed-chain-extend aligner against a fixed reference set."""

    def __init__(
        self, references: dict[str, str], band_width: int = 256, seed_k: int = 15,
        *, device,
    ):
        # torch device of the DP + traceback (ops/sw_batch): the CUDA
        # kernels for a cuda device, their plain versions on the CPU
        self.device = device
        self.band_width = band_width
        self.seed_k = seed_k
        self.ref_names = list(references.keys())
        self.ref_seqs = {n: references[n] for n in self.ref_names}
        self.ref_codes = {n: encode_dna(references[n]) for n in self.ref_names}
        self._ref_id = {n: i for i, n in enumerate(self.ref_names)}
        # the seed index builds on first use: diagonal-reuse callers
        # (map_with_diagonals) never pay for it
        self._seed_index = None

    def map_with_diagonals(self, reads: dict[str, str], targets: dict):
        """Map each read against ONE reference on a known band placement —
        no seeding. `targets` = {read_id: (ref_name, strand, diag)} with
        diag = r_start - q_start of the expected alignment; the band is
        centered there (the polish loop reuses the previous iteration's
        alignment, which drifts far less than the band half-width).
        Returns {read_id: {ref: (strand, Alignment)}} like map_reads."""
        jobs = []
        for rid, seq in reads.items():
            tgt = targets.get(rid)
            if tgt is None:
                continue
            name, strand, diag = tgt
            qseq = seq if strand == "+" else reverse_complement(seq)
            jobs.append(((rid, name), strand, qseq, int(diag)))
        return self._best_per_read(self._run_jobs(jobs))

    def map_sequence(self, seq: str, min_seeds: int = 2):
        """Map one query (both strands) against every reference; returns
        {ref_name: (strand, Alignment)} keeping the best-scoring strand."""
        return self.map_reads({"q": seq}, min_seeds).get("q", {})

    def _jobs_for(self, rid, seq, min_seeds, allowed=None):
        """Alignment jobs of one read: `_seed` of that read alone."""
        return self._seed([(rid, seq, allowed)], min_seeds)

    def _seed(self, items, min_seeds):
        """Alignment jobs of the reads `items` = [(rid, seq, allowed)]: for
        each read, each strand (+ then -), each reference (in `allowed`
        order, a list of distinct names, else the aligner's) and each of
        its seed chains with enough support, (job_tag, strand, qseq, diag)
        with job_tag = (rid, ref). The same list, in the same order, as the
        JAX package's loop over `_seed_chains` per read and reference, from
        one seed index. Reads are seeded in device passes of at most
        SEED_PASS_BASES query bases (a longer read alone)."""
        if self._seed_index is None:
            self._seed_index = _SeedIndex(
                [self.ref_codes[n] for n in self.ref_names], self.seed_k, self.device
            )
        jobs = []
        for i, j in _passes([len(it[1]) for it in items], SEED_PASS_BASES):
            jobs.extend(self._seed_pass(items[i:j], min_seeds))
        TIMER.count("seed_jobs", len(jobs))
        return jobs

    def _seed_pass(self, items, min_seeds, max_chains=4):
        """One device pass of `_seed` (minimap2's seeding and chaining):
        every occurrence of each query k-mer in a reference (repeats are
        left out of the index) gives a diagonal (ref_pos - q_pos); the
        sorted diagonals of each (read, strand, reference) split into
        chains where they jump by more than half the band; a chain is its
        median diagonal and seed count, and the first `max_chains` by count
        (then diagonal) with enough support become jobs. One copy brings
        the job table back to the host. Reads with more than SEED_PASS_HITS
        hits in all are split into passes of fewer, before any hit is
        expanded."""
        idx, k, dev = self._seed_index, self.seed_k, self.device
        n_ref = len(self.ref_names)
        seqs = [it[1] for it in items]
        lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
        read, qpos, fwd, rev = _valid_windows(encode_dna("".join(seqs)), lens, k, dev)
        # both strands; the minus strand's k-mers are those of the reverse
        # complement, in which the window at p starts at len - k - p
        qk = torch.cat([fwd, rev])
        qpos = torch.cat([qpos, torch.from_numpy(lens).to(dev)[read] - k - qpos])
        strand_of = torch.cat([2 * read, 2 * read + 1])  # read * 2 + strand
        lo = torch.searchsorted(idx.kmers, qk)
        n = torch.searchsorted(idx.kmers, qk, right=True) - lo
        total = int(n.sum())
        if total > SEED_PASS_HITS and len(items) > 1:
            hits = torch.zeros(len(items), dtype=torch.int64, device=dev)
            hits.index_add_(0, strand_of >> 1, n)
            return [
                job
                for i, j in _passes(hits.tolist(), SEED_PASS_HITS)
                for job in self._seed_pass(items[i:j], min_seeds, max_chains)
            ]
        TIMER.count("seed_passes")
        TIMER.count("seed_kmers", len(qk))
        if total == 0:
            return []
        q = torch.repeat_interleave(
            torch.arange(len(qk), device=dev), n, output_size=total
        )
        hit = lo[q] + torch.arange(total, device=dev) - (torch.cumsum(n, 0) - n)[q]
        # each hit's reference by its place in the read's order: the id, or
        # for a read with `allowed` the index in that list
        slot = idx.ref[hit]
        limited = [r for r, it in enumerate(items) if it[2] is not None]
        if limited:
            # (read, reference) pairs of the reads with `allowed`, sorted,
            # and each one's place in its list
            pairs = np.array(
                [r * n_ref + self._ref_id[nm] for r in limited for nm in items[r][2]],
                dtype=np.int64,
            )
            places = np.concatenate(
                [np.arange(len(items[r][2])) for r in limited]
            ).astype(np.int64)
            order = np.argsort(pairs)
            lim = np.zeros(len(items), dtype=bool)
            lim[limited] = True
            hread = strand_of[q] >> 1
            keep = ~torch.from_numpy(lim).to(dev)[hread]
            if len(pairs):
                pairs_t = torch.from_numpy(pairs[order]).to(dev)
                pair = hread * n_ref + slot
                at = torch.searchsorted(pairs_t, pair).clamp_(max=len(pairs) - 1)
                found = pairs_t[at] == pair
                keep |= found
                slot = torch.where(found, torch.from_numpy(places[order]).to(dev)[at], slot)
            sel = torch.nonzero(keep).squeeze(1)
            q, hit, slot = q[sel], hit[sel], slot[sel]
        TIMER.count("seed_hits", len(q))
        if len(q) == 0:
            return []
        diag = idx.pos[hit] - qpos[q]
        key = strand_of[q] * n_ref + slot  # read, strand, reference's place
        diag, order = torch.sort(diag, stable=True)
        key, order = torch.sort(key[order], stable=True)
        diag = diag[order]
        # chains: runs of one key's sorted diagonals split where they jump
        # by more than half the band
        first = _starts(key)
        first[1:] |= diag[1:] - diag[:-1] > self.band_width // 2
        s0 = torch.nonzero(first).squeeze(1)
        count = torch.diff(s0, append=s0.new_tensor([len(diag)]))
        # int(np.median(run)): the mean of the two middle values, truncated
        med = torch.div(
            diag[s0 + (count - 1) // 2] + diag[s0 + count // 2], 2, rounding_mode="trunc"
        )
        ckey = key[s0]
        # each key's chains by seed count descending, then diagonal
        order = torch.sort(-count, stable=True).indices
        order = order[torch.sort(ckey[order], stable=True).indices]
        ckey, med, count = ckey[order], med[order], count[order]
        at = torch.arange(len(ckey), device=dev)
        head = torch.cummax(torch.where(_starts(ckey), at, 0), 0).values
        rank = at - head
        # secondary chains need real support relative to the primary (a
        # key's first chain), or noise spawns spurious extension jobs
        ok = (rank < max_chains) & (count >= min_seeds) & (count * 20 >= count[head])
        ckey, diag = torch.stack([ckey[ok], med[ok]]).cpu().numpy()
        return self._job_tuples(items, ckey, diag)

    def _job_tuples(self, items, ckey, diag):
        """The jobs of one pass's job table, whose rows come in job order:
        (read, strand, reference's place, chain rank)."""
        n_ref = len(self.ref_names)
        if len(ckey) == 0:
            return []
        rs = ckey // n_ref
        place = (ckey % n_ref).tolist()
        diag = diag.tolist()
        bounds = (np.flatnonzero(np.diff(rs)) + 1).tolist()
        jobs = []
        for g0, g1 in zip([0, *bounds], [*bounds, len(rs)]):
            r, s = divmod(int(rs[g0]), 2)
            rid, seq, allowed = items[r]
            names = self.ref_names if allowed is None else allowed
            strand, qseq = ("+", seq) if s == 0 else ("-", reverse_complement(seq))
            jobs.extend(
                ((rid, names[f]), strand, qseq, d)
                for f, d in zip(place[g0:g1], diag[g0:g1])
            )
        return jobs

    def _run_jobs(self, jobs):
        """Execute alignment jobs on the query rows their bands can reach,
        grouped by the bucket of that window's length, in chunks whose uint8
        traceback (lq * W bytes per job) stays within 1 GiB.

        The band start is clamped with the bucket of the whole query, where
        the JAX package puts it. Band lane w of query row i is reference
        column i + dlo + w, so only rows i0 .. i1 - 1 can meet the
        reference; the others hold no reference column, can neither raise
        the best cell nor be reached by the traceback, and are left out (a
        job without such rows aligns nowhere and is not launched).

        The alignments come back in the JAX package's order, which ties
        between strands and pieces follow: by the whole query's bucket, in
        the order the buckets first appear, then in job order."""
        W = self.band_width
        out = []
        by_bucket: dict = {}
        first_seen: dict = {}
        for k, job in enumerate(jobs):
            qlen = len(job[2])
            lr = len(self.ref_codes[job[0][1]])
            full = _bucket(qlen)
            # clamp band start: diagonals from "whole query before ref" to
            # "band starts at the last ref base"
            dlo = min(max(job[3] - W // 2, 1 - full), max(lr - 1, 0))
            i0, i1 = max(0, 1 - W - dlo), min(qlen, lr - dlo)
            order = (first_seen.setdefault(full, len(first_seen)), k)
            if i1 > i0:
                by_bucket.setdefault(_bucket(i1 - i0), []).append((job, dlo, i0, i1, order))
        budget = 1 << 30
        for lq, bucket_jobs in by_bucket.items():
            chunk = max(1, budget // (lq * W))
            for c0 in range(0, len(bucket_jobs), chunk):
                self._run_batch(bucket_jobs[c0 : c0 + chunk], lq, W, out)
        out.sort(key=lambda o: o[0])
        return [aln for _order, aln in out]

    def _run_batch(self, batch, lq, W, out):
        """One launch of `sw_cigar` over `batch` = [(job, dlo, i0, i1,
        order)]: each job's query rows i0 .. i1 - 1 with the band start
        dlo + i0, its alignment shifted back to whole-query coordinates and
        appended to `out` beside `order`."""
        from .sw_batch import sw_cigar

        with TIMER.span("align.pack"):
            lr_max = max(len(self.ref_codes[j[0][0][1]]) for j in batch)
            P = W + lq  # real-ref offset inside the padded buffer
            # the band reads reference bytes up to index lr + 2W + 2lq - 3
            rlen = lr_max + 2 * W + 2 * lq
            B = len(batch)
            qs_a = np.full((B, lq), 4, dtype=np.uint8)
            rs_a = np.full((B, rlen), 4, dtype=np.uint8)
            qlens_a = np.empty(B, np.int32)
            dlos_a = np.empty(B, np.int32)
            rows_full = 0
            for bidx, ((tag, _strand, qseq, _diag), dlo, i0, i1, _order) in enumerate(batch):
                qs_a[bidx, : i1 - i0] = encode_dna(qseq[i0:i1])
                rc = self.ref_codes[tag[1]]
                rs_a[bidx, P : P + len(rc)] = rc
                qlens_a[bidx] = i1 - i0
                dlos_a[bidx] = dlo + i0
                rows_full += len(qseq)
        dev = self.device
        with TIMER.span("align.kernels"):
            packed, n_steps, q0s, r0s, best, bi, bw = (
                t.cpu().numpy()
                for t in sw_cigar(
                    torch.from_numpy(qs_a).to(dev), torch.from_numpy(rs_a).to(dev),
                    torch.from_numpy(qlens_a).to(dev), torch.from_numpy(dlos_a).to(dev),
                    W,
                )
            )
            rows_kept = int(qlens_a.sum())
            TIMER.count("launches")
            TIMER.count("jobs", B)
            TIMER.count("rows_full", rows_full)
            TIMER.count("rows_kept", rows_kept)
            TIMER.count("live_cells", rows_kept * W)
            TIMER.count("tb_steps", int(n_steps.sum()))
        with TIMER.span("align.unpack"):
            for bidx, ((tag, strand, qseq, _diag), _dlo, i0, _i1, order) in enumerate(batch):
                if bi[bidx] < 0 or best[bidx] <= 0:
                    continue
                cigar = _unpack_cigar(packed[bidx], int(n_steps[bidx]))
                if not cigar:
                    continue
                aln = Alignment(
                    q_start=int(q0s[bidx]) + i0,
                    q_end=int(bi[bidx]) + 1 + i0,
                    r_start=int(r0s[bidx]),
                    r_end=int(bi[bidx]) + int(dlos_a[bidx]) + int(bw[bidx]) + 1,
                    score=int(best[bidx]),
                    cigar=cigar,
                    q_len=len(qseq),
                    r_len=len(self.ref_codes[tag[1]]),
                )
                out.append((order, (tag, strand, qseq, aln)))

    def map_reads(self, reads: dict[str, str], min_seeds: int = 2, ref_subsets=None):
        """Map many reads in shared batched kernel launches; returns
        {read_id: {ref: (strand, Alignment)}}. `ref_subsets` optionally
        restricts each read to {read_id: [ref names]} (used to batch many
        independent per-cluster mapping problems into one launch set)."""
        with TIMER.span("align.seed"):
            jobs = self._seed(
                [
                    (rid, seq, None if ref_subsets is None else ref_subsets.get(rid))
                    for rid, seq in reads.items()
                ],
                min_seeds,
            )
        return self._best_per_read(self._run_jobs(jobs))

    @staticmethod
    def _best_per_read(aligned):
        """{read_id: {ref: (strand, Alignment)}} from the batches' output:
        each (read, ref, strand)'s pieces z-drop split and stitched, and the
        best-scoring strand kept."""
        with TIMER.span("align.stitch"):
            raw: dict = {}
            for (rid, name), strand, _qseq, aln in aligned:
                raw.setdefault((rid, name, strand), []).append(aln)
            results: dict = {}
            for (rid, name, strand), alns in raw.items():
                pieces = []
                for a in alns:
                    pieces.extend(_zdrop_split(a))
                if not pieces:
                    continue
                best = _stitch_pieces(pieces) if len(pieces) > 1 else pieces[0]
                per_read = results.setdefault(rid, {})
                prev = per_read.get(name)
                if prev is None or best.score > prev[1].score:
                    per_read[name] = (strand, best)
        return results
