"""Consensus polishing of a draft sequence from read alignments (racon
replacement).

The reference runs 5 iterations of minimap2 + `racon -u --no-trimming
-w <len+200>` (result_utils.py:285-335, 541-556): with a window larger than
the sequence, racon computes a single partial-order-alignment consensus of
all read segments against the draft backbone. Here each iteration re-aligns
the reads with the banded SW kernel and takes a weighted column consensus
(substitutions, deletions, and majority insertions), which converges to the
same consensus on ONT-coverage data; iterating against re-alignment plays
the role of POA's joint alignment.
"""

from __future__ import annotations

import numpy as np

from .align import Aligner, reverse_complement

_BASES = "ACGT"
_BASE_IDX = {b: i for i, b in enumerate(_BASES)}
# char -> vote column (0..3 = ACGT upper/lower, -1 = not a base)
_CHAR_LUT = np.full(256, -1, dtype=np.int16)
for _i, _b in enumerate(_BASES):
    _CHAR_LUT[ord(_b)] = _i
    _CHAR_LUT[ord(_b.lower())] = _i


def consensus_from_alignments(draft: str, alignments) -> str:
    """One consensus round.

    alignments: iterable of (strand, Alignment, oriented_query_seq) where
    oriented_query_seq is the query in the orientation that was aligned.
    """
    L = len(draft)
    # votes[pos, 0:4] = base votes (match or substitution), [pos, 4] = deletion
    # accumulated as one bincount over flattened (pos, column) keys — within
    # one alignment draft positions are strictly increasing, so per-op slices
    # need no dedup
    pos_chunks: list[np.ndarray] = []
    col_chunks: list[np.ndarray] = []
    insertions: dict[int, dict[str, int]] = {}
    for strand, aln, qseq in alignments:
        qcodes = _CHAR_LUT[np.frombuffer(qseq.encode("latin-1"), np.uint8)]
        qi = aln.q_start
        ri = aln.r_start
        for op, n in aln.cigar:
            if op == "=" or op == "X":
                c = qcodes[qi : qi + n]
                m = c >= 0
                if m.all():
                    pos_chunks.append(np.arange(ri, ri + n))
                    col_chunks.append(c)
                elif m.any():
                    pos_chunks.append(np.arange(ri, ri + n)[m])
                    col_chunks.append(c[m])
                qi += n
                ri += n
            elif op == "I":
                ins = qseq[qi : qi + n].upper()
                slot = insertions.setdefault(ri, {})
                slot[ins] = slot.get(ins, 0) + 1
                qi += n
            elif op == "D":
                pos_chunks.append(np.arange(ri, ri + n))
                col_chunks.append(np.full(n, 4, dtype=np.int16))
                ri += n
    if pos_chunks:
        flat = np.concatenate(pos_chunks) * 5 + np.concatenate(col_chunks)
        votes = np.bincount(
            flat.astype(np.int64), minlength=L * 5
        ).reshape(L, 5).astype(np.int32)
    else:
        votes = np.zeros((L, 5), dtype=np.int32)
    # column choices, fully vectorized (one pass instead of a per-position
    # Python loop): covered columns take the vote argmax with ties broken
    # toward the draft base; uncovered columns keep the ORIGINAL draft char;
    # a winning deletion emits nothing (encoded as byte 0, dropped below)
    depth = votes.sum(axis=1)
    draft_arr = np.frombuffer(draft.encode("latin-1"), np.uint8)
    if L:
        best = votes.argmax(axis=1)
        draft_codes = _CHAR_LUT[draft_arr]
        dc = np.where(draft_codes >= 0, draft_codes, 0)
        rows = np.arange(L)
        tie = (draft_codes >= 0) & (votes[rows, dc] == votes[rows, best])
        best = np.where(tie, dc, best)
        base_bytes = np.frombuffer(b"ACGT\0", np.uint8)[best]
        emit = np.where(depth == 0, draft_arr, base_bytes).astype(np.uint8)
    else:
        emit = draft_arr
    if not insertions:
        return emit[emit != 0].tobytes().decode("latin-1")
    # splice majority insertions in at their (sparse) positions
    parts = []
    prev = 0
    for pos in sorted(insertions):
        ins_votes = insertions[pos]
        best_ins, n_ins = max(ins_votes.items(), key=lambda kv: kv[1])
        if pos < L:
            local_depth = depth[pos] if depth[pos] > 0 else 1
        else:
            local_depth = depth[L - 1] if L and depth[L - 1] > 0 else 1
        if n_ins * 2 > local_depth:
            seg = emit[prev:pos]
            parts.append(seg[seg != 0].tobytes().decode("latin-1"))
            parts.append(best_ins)
            prev = pos
    seg = emit[prev:]
    parts.append(seg[seg != 0].tobytes().decode("latin-1"))
    return "".join(parts)


def polish_once(draft: str, reads: dict[str, str], band_width: int = 256, *, device):
    """Align every read to the draft on `device` and emit the consensus (one
    racon_one_iteration equivalent). Returns (consensus, alignments)."""
    aligner = Aligner({"draft": draft}, band_width=band_width, device=device)
    alns = []
    for rid, hits in aligner.map_reads(reads).items():
        if "draft" not in hits:
            continue
        strand, aln = hits["draft"]
        seq = reads[rid]
        oriented = seq if strand == "+" else reverse_complement(seq)
        alns.append((strand, aln, oriented))
    if not alns:
        return draft, []
    return consensus_from_alignments(draft, alns), alns


def polish(
    draft: str, reads: dict[str, str], iterations: int = 5, band_width: int = 256,
    *, device,
) -> str:
    """Iterated polish: re-align + consensus, `iterations` times
    (result_utils.py:541-556)."""
    seq = draft
    for _ in range(iterations):
        new_seq, alns = polish_once(seq, reads, band_width, device=device)
        if not alns:
            break
        if new_seq == seq:
            break  # converged
        seq = new_seq
    return seq
