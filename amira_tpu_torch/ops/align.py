"""Banded two-piece-affine local alignment (minimap2 replacement).

Port of `amira_tpu/ops/align.py`. The reference shells out to minimap2
(`-a --MD -x map-ont --eqx`, result_utils.py:259-276) for read->allele and
allele->allele alignment. Here each batch of alignment jobs runs the banded
DP and its traceback as two hand-written CUDA kernels on the GPU
(`ops/sw_batch.py`, `csrc/sw_batch.cu`), or their plain PyTorch versions on
the CPU: M/I/D/I2/D2 band vectors with two-piece affine gaps (minimap2's
-O 4,24 -E 2,1), traceback directions packed one byte per cell, and the walk
emitting 2-bit-packed =/X/I/D op sequences (minimap2 --eqx semantics).

Band placement is seed-chain-extend, on the host and unchanged from the JAX
package: shared-15-mer hits are clustered by diagonal into chains, the top
chains each get a banded extension, z-drop (minimap2 -z) splits alignments
across bad joins, and collinear chain pieces are stitched back together
with two-piece gap costs, so a read with a structural gap wider than the
band still maps as one alignment with a long I/D run. Pairs with no seeds
are reported unmapped.

Under an open phase (`tracing`), each `map_reads` is divided into spans:
`align.seed` (the seed chains), then per batch `align.pack` (the job
arrays), `align.kernels` (the DP and traceback and the copies back, the
host waiting for the card) and `align.unpack` (the CIGARs), and last
`align.stitch` (z-drop split and stitch; `map_with_diagonals` has the
batches and the stitch). `align.kernels` counts the batch's `launches`
(one `sw_cigar`: one sw_dp and one sw_traceback launch), `jobs`,
`live_cells` (query bases x band width, the DP's cells) and `tb_steps`
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
    clamp in `_run_batch`, so this keeps alignments equal to the JAX
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


class _SeedIndex:
    """One seed index over every reference: each valid k-mer of each
    reference as (k-mer, reference id, position), sorted in that order. A
    query strand's k-mers find their hits on all references at once (the
    JAX package searches each reference's own index in turn): the top
    `bits` bits of a k-mer name its bucket, and `start` holds where each
    bucket begins in the sorted arrays, so a lookup is two gathers and a
    compare over the few entries that share the bucket."""

    __slots__ = ("kmers", "ref", "pos", "shift", "start")

    def __init__(self, codes: list, k: int):
        # the references back to back, each followed by k invalid codes, so
        # that no valid window spans two of them
        sep = np.full(k, 255, dtype=np.uint8)
        parts = [p for c in codes for p in (c, sep)]
        cat = np.concatenate(parts) if parts else np.zeros(0, dtype=np.uint8)
        starts = np.cumsum([0] + [len(c) + k for c in codes[:-1]]).astype(np.int64)
        km = _forward_kmers(cat, k)
        at = np.nonzero(km != _KMER_SENTINEL)[0].astype(np.int64)
        # stable: equal k-mers stay in (reference, position) order
        order = np.argsort(km[at], kind="stable")
        at = at[order]
        self.kmers = km[at]
        self.ref = np.searchsorted(starts, at, side="right") - 1
        self.pos = at - starts[self.ref]
        # about two buckets per entry, at most one per k-mer
        bits = min(max(len(self.kmers).bit_length() + 1, 8), 2 * k)
        self.shift = np.uint64(2 * k - bits)
        counts = np.bincount(
            (self.kmers >> self.shift).astype(np.int64), minlength=1 << bits
        )
        self.start = np.concatenate([[0], np.cumsum(counts)])

    def chains(self, qkmers, band_width, max_occ=8, max_chains=4, allowed=None):
        """The seed chains of one query strand against every reference at
        once (minimap2's chaining stage): all occurrences of each query
        k-mer in a reference, unless there are more than `max_occ`, give a
        diagonal (ref_pos - q_pos), and a reference's sorted diagonals split
        into chains where they jump by more than half the band. Returns
        (ref, diag, count) arrays of each reference's first `max_chains`
        chains (median diagonal, seed count), grouped by reference id
        ascending and, within a reference, in the order of the JAX
        package's `_seed_chains` (seed count descending, then diagonal). A
        reference's chains depend only on the multiset of its kept
        diagonals (the median of each sorted run and the stable sort by
        count), which is what this computes. `allowed` is an optional bool
        mask over reference ids."""
        qk, qpos = qkmers
        empty = np.zeros(0, dtype=np.int64)
        if len(qk) == 0 or len(self.kmers) == 0:
            return empty, empty, empty
        # each query k-mer against every entry of its bucket; the entries
        # equal to it are its hits, in index order
        bucket = (qk >> self.shift).astype(np.int64)
        lo = self.start[bucket]
        n = self.start[bucket + 1] - lo
        total = int(n.sum())
        if total == 0:
            return empty, empty, empty
        q_id = np.repeat(np.arange(len(qk)), n)
        hit = np.repeat(lo - (np.cumsum(n) - n), n) + np.arange(total)
        same = self.kmers[hit] == qk[q_id]
        hit, q_id = hit[same], q_id[same]
        total = len(hit)
        if total == 0:
            return empty, empty, empty
        ref = self.ref[hit]
        qp = qpos[q_id]
        # occurrences of one query k-mer in one reference are one run of
        # its hits: drop runs longer than max_occ (repeats)
        cut = np.flatnonzero((q_id[1:] != q_id[:-1]) | (ref[1:] != ref[:-1])) + 1
        run_len = np.diff(np.concatenate([[0], cut, [total]]))
        keep = np.repeat(run_len <= max_occ, run_len)
        if allowed is not None:
            keep &= allowed[ref]
        ref = ref[keep]
        diag = self.pos[hit[keep]] - qp[keep]
        if len(ref) == 0:
            return empty, empty, empty
        order = np.lexsort((diag, ref))
        ref, diag = ref[order], diag[order]
        # chains: runs of one reference's sorted diagonals split where they
        # jump by more than half the band
        cut = np.flatnonzero(
            (ref[1:] != ref[:-1]) | (np.diff(diag) > band_width // 2)
        ) + 1
        s0 = np.concatenate([[0], cut])
        s1 = np.concatenate([cut, [len(ref)]])
        count = s1 - s0
        # int(np.median(run)): the mean of the two middle values, truncated
        med = np.trunc(
            (diag[s0 + (count - 1) // 2] + diag[s0 + count // 2]) / 2.0
        ).astype(np.int64)
        cref = ref[s0]
        order = np.lexsort((np.arange(len(count)), -count, cref))
        cref, med, count = cref[order], med[order], count[order]
        first = np.concatenate([[True], cref[1:] != cref[:-1]])
        group_start = np.maximum.accumulate(
            np.where(first, np.arange(len(cref)), 0)
        )
        rank = np.arange(len(cref)) - group_start
        keep = rank < max_chains
        return cref[keep], med[keep], count[keep]


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
        """Alignment jobs of one read: for each strand, each reference (in
        `allowed` order, else the aligner's) and each of its seed chains
        with enough support, (job_tag, strand, qseq, diag) with job_tag =
        (rid, ref). The same list, in the same order, as the JAX package's
        loop over `_seed_chains` per reference, from one seed index."""
        if self._seed_index is None:
            self._seed_index = _SeedIndex(
                [self.ref_codes[n] for n in self.ref_names], self.seed_k
            )
        mask = None
        if allowed is not None:
            mask = np.zeros(len(self.ref_names), dtype=bool)
            ids = [self._ref_id[n] for n in allowed]
            mask[ids] = True
        jobs = []
        for strand, qseq in (("+", seq), ("-", reverse_complement(seq))):
            qkmers = query_seed_kmers(encode_dna(qseq), self.seed_k)
            ref, diag, count = self._seed_index.chains(
                qkmers, self.band_width, allowed=mask
            )
            if len(ref) == 0:
                continue
            # secondary chains need real support relative to the primary
            # (a reference's first chain), or noise spawns spurious
            # extension jobs
            first = np.concatenate([[True], ref[1:] != ref[:-1]])
            top = count[np.maximum.accumulate(
                np.where(first, np.arange(len(ref)), 0)
            )]
            ok = (count >= min_seeds) & (count * 20 >= top)
            ref, diag = ref[ok].tolist(), diag[ok].tolist()
            if allowed is None:
                names = self.ref_names
                jobs.extend(
                    ((rid, names[r]), strand, qseq, d) for r, d in zip(ref, diag)
                )
                continue
            by_ref: dict = {}
            for r, d in zip(ref, diag):
                by_ref.setdefault(r, []).append(d)
            for name, r in zip(allowed, ids):
                jobs.extend(
                    ((rid, name), strand, qseq, d) for d in by_ref.get(r, ())
                )
        return jobs

    def _run_jobs(self, jobs):
        """Execute alignment jobs grouped by query-length bucket, in chunks
        whose uint8 traceback (lq * W bytes per job) stays within 1 GiB."""
        W = self.band_width
        out = []
        by_bucket: dict = {}
        for job in jobs:
            lq = _bucket(len(job[2]))
            by_bucket.setdefault(lq, []).append(job)
        budget = 1 << 30
        for lq, bucket_jobs in by_bucket.items():
            chunk = max(1, budget // (lq * W))
            for c0 in range(0, len(bucket_jobs), chunk):
                self._run_batch(bucket_jobs[c0 : c0 + chunk], lq, W, out)
        return out

    def _run_batch(self, batch, lq, W, out):
        from .sw_batch import sw_cigar

        with TIMER.span("align.pack"):
            lr_max = max(len(self.ref_codes[j[0][1]]) for j in batch)
            P = W + lq  # real-ref offset inside the padded buffer
            # the band reads reference bytes up to index lr + 2W + 2lq - 3
            rlen = lr_max + 2 * W + 2 * lq
            B = len(batch)
            qs_a = np.full((B, lq), 4, dtype=np.uint8)
            rs_a = np.full((B, rlen), 4, dtype=np.uint8)
            qlens_a = np.empty(B, np.int32)
            dlos_a = np.empty(B, np.int32)
            for bidx, (tag, strand, qseq, diag) in enumerate(batch):
                qc = encode_dna(qseq)
                qs_a[bidx, : len(qc)] = qc
                rc = self.ref_codes[tag[1]]
                rs_a[bidx, P : P + len(rc)] = rc
                qlens_a[bidx] = len(qc)
                # clamp band start: diagonals from "whole query before ref" to
                # "band starts at the last ref base"
                dlos_a[bidx] = int(
                    np.clip(diag - W // 2, -(lq - 1), max(len(rc) - 1, 0))
                )
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
            TIMER.count("launches")
            TIMER.count("jobs", B)
            TIMER.count("live_cells", int(qlens_a.sum()) * W)
            TIMER.count("tb_steps", int(n_steps.sum()))
        with TIMER.span("align.unpack"):
            for bidx, (tag, strand, qseq, _diag) in enumerate(batch):
                if bi[bidx] < 0 or best[bidx] <= 0:
                    continue
                cigar = _unpack_cigar(packed[bidx], int(n_steps[bidx]))
                if not cigar:
                    continue
                aln = Alignment(
                    q_start=int(q0s[bidx]),
                    q_end=int(bi[bidx]) + 1,
                    r_start=int(r0s[bidx]),
                    r_end=int(bi[bidx]) + int(dlos_a[bidx]) + int(bw[bidx]) + 1,
                    score=int(best[bidx]),
                    cigar=cigar,
                    q_len=len(qseq),
                    r_len=len(self.ref_codes[tag[1]]),
                )
                out.append((tag, strand, qseq, aln))

    def map_reads(self, reads: dict[str, str], min_seeds: int = 2, ref_subsets=None):
        """Map many reads in shared batched kernel launches; returns
        {read_id: {ref: (strand, Alignment)}}. `ref_subsets` optionally
        restricts each read to {read_id: [ref names]} (used to batch many
        independent per-cluster mapping problems into one launch set)."""
        jobs = []
        with TIMER.span("align.seed"):
            for rid, seq in reads.items():
                allowed = None if ref_subsets is None else ref_subsets.get(rid)
                jobs.extend(self._jobs_for(rid, seq, min_seeds, allowed))
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
