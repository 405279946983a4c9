"""Multi-copy AMR path clustering: assign each read to a specific genomic
copy of each AMR gene by its graph context.

Reference semantics: amira/construct_graph.py:2360-2959 and
amira/path_finding_utils.py. The reference's generalized suffix trees are
replaced by posting-list sequence indexes (amira_tpu/stree.py) that answer
the same contains/suffix queries; all answers are identical.
"""

from __future__ import annotations

import numpy as np

from .stree import SequenceIndex, find_sublist_indices, is_sublist
from .tracing import TIMER


# ------------------------------------------------------------------ anchors


def get_AMR_anchors(graph, AMRNodes):
    """AMR nodes that border non-AMR context (path endpoints), with the
    singleton/terminal-occurrence heuristics and the 0.3 terminal-ratio
    rule (behavioral contract: construct_graph.py:2629-2691, matched
    bug-for-bug incl. the fw-derived backward check and the
    stop-at-first-singleton truncation of the terminal tally).

    Each distinct read is digested ONCE into (occurrence indices per AMR
    node, per-position AMR flags) and the digest is shared across every
    AMR node the read touches — the per-(node, read) rescan of the whole
    node list made this O(reads x occurrences x read length)."""
    AMRNodes = set(AMRNodes)
    nodeAnchors = set()
    terminals: dict = {}
    read_nodes_map = graph.get_readNodes()

    digest_cache: dict = {}

    def _digest(r):
        info = digest_cache.get(r)
        if info is None:
            rn = read_nodes_map[r]
            occ: dict = {}
            amr = np.zeros(len(rn), bool)
            for i, nh in enumerate(rn):
                if nh in AMRNodes:
                    amr[i] = True
                    occ.setdefault(nh, []).append(i)
            info = digest_cache[r] = (occ, amr, len(rn))
        return info

    for nodeHash in AMRNodes:
        term = terminals[nodeHash] = []
        node = graph.get_node_by_hash(nodeHash)
        is_anchor = False
        # both side checks intentionally derive from the FORWARD
        # neighbors (the reference quirk at construct_graph.py:2644-2646)
        if not any(
            n.hash != nodeHash for n in graph.get_forward_neighbors(node)
        ):
            nodeAnchors.add(nodeHash)
        all_singleton = True
        for r in node.reads:
            occ, amr, ln = _digest(r)
            if ln == 1 and nodeHash in occ:
                # singleton read: tally a terminal and stop the scan
                term.append(True)
                break
            all_singleton = False
            for index in occ.get(nodeHash, ()):
                if index != 0 and index != ln - 1:
                    if not (amr[index - 1] and amr[index + 1]):
                        is_anchor = True
                        break
                    term.append(False)
                else:
                    term.append(True)
            if is_anchor:
                nodeAnchors.add(nodeHash)
                break
        if all_singleton or all(term):
            has_fwd_amr = any(
                n.hash in AMRNodes
                for n in graph.get_forward_neighbors(node)
            )
            has_bwd_amr = any(
                n.hash in AMRNodes
                for n in graph.get_backward_neighbors(node)
            )
            if not (has_fwd_amr and has_bwd_amr):
                nodeAnchors.add(nodeHash)
    for nodeHash, term in terminals.items():
        if term and term.count(True) / len(term) > 0.3:
            nodeAnchors.add(nodeHash)
    return nodeAnchors


# ------------------------------------------------------------ context paths


def construct_node_index(read_nodes: dict) -> SequenceIndex:
    """Index of per-read node-hash sequences plus their reverses (for reads
    visiting more than one distinct node), mirroring
    path_finding_utils.py:79-85.

    Reads with identical node sequences are deduplicated: the index holds
    one representative per distinct sequence (clustering runs after read
    correction, where most reads share graph paths, so queries scale with
    DISTINCT paths, not read count). `_rep_members` maps each representative
    (and its `_reverse` twin) back to every read id in its group — the only
    per-read answer downstream (generate_full_paths' read support) expands
    through it; every other consumer depends only on the sequences, for
    which representative-level answers are exact."""
    seqs: dict = {}
    members: dict = {}
    seen: dict = {}
    for r, nl in read_nodes.items():
        key = tuple(nl)
        rep = seen.get(key)
        if rep is None:
            seen[key] = rep = r
            seqs[r] = nl
            grp = members[r] = [r]
            if len(set(nl)) != 1:
                seqs[r + "_reverse"] = list(reversed(nl))
                members[r + "_reverse"] = grp
        else:
            members[rep].append(r)
    idx = SequenceIndex(seqs)
    idx._rep_members = members
    return idx


def cluster_adjacent_paths(adjacent_paths, upstream: bool):
    """Cluster context subpaths by prefix (downstream) / suffix (upstream)
    containment; representative = shortest member
    (path_finding_utils.py:11-64)."""
    sorted_paths = sorted([k for k in adjacent_paths], key=len, reverse=True)
    clustered: dict = {}
    for p in sorted_paths:
        list_p = list(p)
        supported = []
        for c in clustered:
            list_c = list(c)
            if upstream:
                match = bool(list_p) and list_p == list_c[-len(list_p):]
            else:
                match = bool(list_p) and list_p == list_c[: len(list_p)]
            if match or not list_p:
                supported.append(c)
        if len(supported) == 0:
            clustered[p] = {p}
        if len(supported) == 1:
            clustered[supported[0]].add(p)
    final = {}
    for c in clustered:
        final[min(list(clustered[c]), key=len)] = {
            "longest": max(list(clustered[c]), key=len),
            "all": list(clustered[c]),
        }
    return final


def get_all_context_options(nodes_on_read, start, end):
    up = tuple(nodes_on_read[:start])
    up_options = {up[i:] for i in range(len(up))}
    down = tuple(nodes_on_read[end + 1 :])
    down_options = {down[:i] for i in range(1, len(down) + 1)}
    up_options.add(())
    down_options.add(())
    return up_options, down_options


def get_canonical_representation(block):
    return sorted([block, list(reversed(block))])[0]


# Context semantics for reverse-oriented reads: "accumulate" (default) is
# orientation-order-independent; "replace" mirrors the reference's overwrite
# (path_finding_utils.py:153-162) and exists so the divergence can be
# bounded on real data (tests/test_cluster_divergence.py).
CONTEXT_REVERSE_MODE = "accumulate"


def _get_full_path_contexts(
    positions_of_path, contexts, reads, read_id, block_reads, ctx_memo=None
):
    start, end = positions_of_path[0]
    if ctx_memo is None:
        up_options, down_options = get_all_context_options(reads[read_id], start, end)
    else:
        # the same (read, span) is revisited for every anchor pair whose
        # block lands on it; the option sets are immutable tuples -> memoize
        memo_key = (read_id, start, end)
        cached = ctx_memo.get(memo_key)
        if cached is None:
            cached = get_all_context_options(reads[read_id], start, end)
            ctx_memo[memo_key] = cached
        up_options, down_options = cached
    canonical = get_canonical_representation(block_reads[read_id])
    canonical_tuple = tuple(canonical)
    if canonical == block_reads[read_id]:
        if canonical_tuple not in contexts:
            contexts[canonical_tuple] = {"upstream": set(), "downstream": set()}
        contexts[canonical_tuple]["upstream"].update(up_options)
        contexts[canonical_tuple]["downstream"].update(down_options)
    else:
        # reverse orientation: swap and reverse the context options.
        # The reference overwrites the context sets here instead of
        # accumulating (path_finding_utils.py:153-162), which makes the
        # result depend on which orientation its sha256 hash order happens
        # to canonicalize to (reads processed later erase earlier reads'
        # diverging contexts). The behavior its test corpus pins down
        # (test_path_finding.py:743, diverging terminals -> 2 paths) needs
        # every read's contexts, so we accumulate symmetrically.
        # CONTEXT_REVERSE_MODE = "replace" reproduces the reference's
        # overwrite so the divergence can be MEASURED on real fixtures
        # (tests/test_cluster_divergence.py bounds it).
        rv_up = {tuple(reversed(list(u))) for u in up_options}
        rv_down = {tuple(reversed(list(d))) for d in down_options}
        if CONTEXT_REVERSE_MODE == "replace":
            contexts[canonical_tuple] = {"upstream": rv_down, "downstream": rv_up}
            return
        if canonical_tuple not in contexts:
            contexts[canonical_tuple] = {"upstream": set(), "downstream": set()}
        contexts[canonical_tuple]["upstream"].update(rv_down)
        contexts[canonical_tuple]["downstream"].update(rv_up)


def get_blocks_from_index(suffix_index: SequenceIndex, a2, nodeAnchors):
    """Anchor-to-anchor blocks from the reversed-suffix index
    (path_finding_utils.py:103-123)."""
    block_reads: dict = {}
    block_duplicates: dict = {}
    for read_id, pos in suffix_index.find_all([a2]):
        path_list = suffix_index.sequences[read_id][pos:]
        assert path_list[0] in nodeAnchors and path_list[-1] in nodeAnchors
        canonical_tuple = tuple(get_canonical_representation(path_list))
        block_duplicates[canonical_tuple] = False
        if "_reverse" not in str(read_id):
            cand = list(reversed(path_list))
            if read_id not in block_reads or len(cand) > len(block_reads[read_id]):
                block_reads[read_id] = cand
    return block_reads, block_duplicates


def generate_contexts(block_reads, block_duplicates, reads, ctx_memo=None):
    contexts: dict = {}
    for read_id in block_reads:
        block = block_reads[read_id]
        positions_of_path = find_sublist_indices(reads[read_id], block)
        assert len(positions_of_path) > 0
        canonical_tuple = tuple(get_canonical_representation(block))
        if len(positions_of_path) > 1:
            block_duplicates[canonical_tuple] = True
        if len(positions_of_path) == 1:
            _get_full_path_contexts(
                positions_of_path, contexts, reads, read_id, block_reads, ctx_memo
            )
    return contexts


def generate_full_paths(contexts, block_duplicates, full_blocks, node_index, threshold):
    members = getattr(node_index, "_rep_members", None)
    for c in contexts:
        if block_duplicates[c] is False:
            up_clusters = cluster_adjacent_paths(contexts[c]["upstream"], upstream=True)
            down_clusters = cluster_adjacent_paths(
                contexts[c]["downstream"], upstream=False
            )
            full_paths = [u + c + d for u in up_clusters for d in down_clusters]
            for f in full_paths:
                ids = node_index.find_ids(list(f))
                if members is None:
                    reads_with_full_path = {
                        str(sid).replace("_reverse", "") for sid in ids
                    }
                else:
                    # dedup index: fan matched representatives back out to
                    # every read in their groups (identical sequences)
                    reads_with_full_path = set()
                    for sid in ids:
                        reads_with_full_path.update(members[sid])
                if len(reads_with_full_path) > 0:
                    full_blocks[tuple(f)] = reads_with_full_path


def process_anchors(
    suffix_index, nodeAnchors, a1, full_blocks, reads, node_index, threshold,
    ctx_memo=None,
):
    for a2 in nodeAnchors:
        if a1 != a2:
            block_reads, block_duplicates = get_blocks_from_index(
                suffix_index, a2, nodeAnchors
            )
            contexts = generate_contexts(block_reads, block_duplicates, reads, ctx_memo)
            generate_full_paths(
                contexts, block_duplicates, full_blocks, node_index, threshold
            )


def process_anchors_from_positions(
    node_index, anchor_pos, nodeAnchors, a1, full_blocks, threshold, ctx_memo
):
    """process_anchors without materializing the per-anchor reversed-suffix
    sub-index: blocks come straight from each read's anchor-position lists.

    For anchor a1, the reversed suffix of read `sid` starts at a1's FIRST
    occurrence p1; an occurrence of a2 at position i >= p1 contributes the
    block reversed(seq[p1:i+1]) — exactly what get_blocks_from_index
    extracts from the sub-index, in the same (read-major, i-descending)
    order, so block_reads/block_duplicates contents and insertion order are
    identical."""
    suffix_sids = []
    p1_of: dict = {}
    for sid, pos in node_index.posting_pairs(a1):
        if sid not in p1_of:
            p1_of[sid] = pos
            suffix_sids.append(sid)
    blocks_by_a2: dict = {}
    for sid in suffix_sids:
        amap = anchor_pos.get(sid)
        if not amap:
            continue
        p1 = p1_of[sid]
        seq = node_index.sequences[sid]
        is_fwd = "_reverse" not in str(sid)
        for a2, apos in amap.items():
            if a2 == a1:
                continue
            entry = blocks_by_a2.get(a2)
            if entry is None:
                entry = blocks_by_a2[a2] = ({}, {})
            block_reads, block_duplicates = entry
            for i in reversed(apos):
                if i < p1:
                    break
                cand = seq[p1 : i + 1]
                block_duplicates[tuple(get_canonical_representation(cand))] = False
                if is_fwd and (
                    sid not in block_reads or len(cand) > len(block_reads[sid])
                ):
                    block_reads[sid] = cand
    for a2 in nodeAnchors:
        if a2 == a1 or a2 not in blocks_by_a2:
            continue
        block_reads, block_duplicates = blocks_by_a2[a2]
        contexts = generate_contexts(
            block_reads, block_duplicates, node_index.sequences, ctx_memo
        )
        generate_full_paths(
            contexts, block_duplicates, full_blocks, node_index, threshold
        )


def filter_blocks(full_blocks):
    """Drop node-blocks contained (fw or rv) in an already-kept longer block
    (path_finding_utils.py:250-259)."""
    filtered: dict = {}
    for p in sorted(list(full_blocks.keys()), key=len, reverse=True):
        p_list = list(p)
        rv_p_list = list(reversed(p_list))
        if not any(
            is_sublist(list(f), p_list) or is_sublist(list(f), rv_p_list)
            for f in filtered
        ):
            filtered[p] = full_blocks[p]
    return filtered


# ------------------------------------------------------ gene-window support


def get_all_sublists(gene_index: SequenceIndex, lst, threshold, geneOfInterest):
    """All gene windows of the unitig containing every copy of the gene, with
    read support >= threshold (construct_graph.py:2711-2723 +
    path_finding_utils.py:296-310).

    Support counting runs in one pass: every candidate window spans the
    maximal [first_copy, last_copy] core, so a window occurs in a read
    exactly where a core occurrence extends left/right through the window's
    extra symbols. One find_all(core) plus per-occurrence extent arithmetic
    and a 2D suffix-sum histogram replaces one contains-query per window —
    identical window keys, counts, and insertion order."""
    sublists = {}
    fw, bw = f"+{geneOfInterest}", f"-{geneOfInterest}"
    copy_idx = [i for i, g in enumerate(lst) if g == fw or g == bw]
    if not copy_idx:
        # blocks are anchored on nodes containing the gene, so a block gene
        # list without it should be unreachable; log loudly rather than
        # silently dropping the block if that assumption ever breaks
        import sys

        sys.stderr.write(
            f"\namira-tpu: WARNING: block without {geneOfInterest} in "
            "sublist support search; block skipped.\n"
        )
        return sublists
    # a window contains every copy of the gene iff it spans
    # [first_copy, last_copy] — enumerate exactly those windows instead of
    # all O(L^2) windows (identical key set: windows are dict keys, so
    # duplicate contents collapse either way)
    first, last = copy_idx[0], copy_idx[-1]
    n_left = first + 1  # window starts s; a = first - s counts left symbols
    n_right = len(lst) - last  # window ends e; b = e - last right symbols
    core = lst[first : last + 1]
    # per occurrence, vectorized (L, R) extents of the core occurrence (an
    # occurrence of the (s, e) window in a read IS a core occurrence
    # extending first-s left and e-last right, because every window
    # occurrence contains a core occurrence at a fixed offset)
    starts, seq_idx = gene_index.find_all_abs(core)
    if len(starts) == 0:
        return sublists
    tok, off = gene_index.tok, gene_index.off
    sym_of = gene_index._sym_ids.get
    n_occ = len(starts)
    L = np.zeros(n_occ, dtype=np.int64)
    alive = np.ones(n_occ, dtype=bool)
    lo = off[seq_idx]
    for t in range(first):
        want = sym_of(lst[first - 1 - t])
        if want is None:
            break
        p = starts - 1 - t
        ok = alive & (p >= lo)
        ok[ok] = tok[p[ok]] == want
        L[ok] += 1
        alive = ok
        if not alive.any():
            break
    end0 = starts + (last - first)
    hi = off[seq_idx + 1]
    R = np.zeros(n_occ, dtype=np.int64)
    alive = np.ones(n_occ, dtype=bool)
    for t in range(n_right - 1):
        want = sym_of(lst[last + 1 + t])
        if want is None:
            break
        p = end0 + 1 + t
        ok = alive & (p < hi)
        ok[ok] = tok[p[ok]] == want
        R[ok] += 1
        alive = ok
        if not alive.any():
            break
    # occurrences of a read and of its "_reverse" twin count as ONE read;
    # on a dedup index (_weighted_gene_index) a "read" here is a linked
    # group of identical sequences and counts with its base-read weight
    weight = getattr(gene_index, "_base_weight", None)
    base_idx = getattr(gene_index, "_base_idx", None)
    if base_idx is None:
        interned: dict = {}
        base_idx = np.empty(len(gene_index._sids), dtype=np.int64)
        for i, sid in enumerate(gene_index._sids):
            b = str(sid).replace("_reverse", "")
            base_idx[i] = interned.setdefault(b, len(interned))
        gene_index._base_idx = base_idx
    base = base_idx[seq_idx]
    # a read supports window (a = first-s left, b = e-last right symbols)
    # iff some occurrence has L >= a and R >= b: a union of staircase
    # rectangles [0..L]x[0..R]. Inclusion-exclusion over each read's pareto
    # frontier gives signed corner points; one scatter-add plus a 2D suffix
    # sum counts every window at once.
    order = np.lexsort((-R, -L, base))
    b_s, L_s, R_s = base[order], L[order], R[order]
    new_grp = np.empty(n_occ, dtype=bool)
    new_grp[0] = True
    new_grp[1:] = b_s[1:] != b_s[:-1]
    grp = np.cumsum(new_grp) - 1
    # exclusive running max of R within each group (L is descending inside
    # a group, so a point is on the pareto frontier iff its R strictly
    # exceeds every earlier R in its group)
    big = np.int64(n_right + 1)
    keyed = grp * big + R_s
    run = np.maximum.accumulate(keyed)
    prev = np.empty(n_occ, dtype=np.int64)
    prev[0] = -1
    prev[1:] = run[:-1] - grp[1:] * big  # negative at group starts
    keep = R_s > np.maximum(prev, -1)
    keep[new_grp] = True
    kL, kR, kg = L_s[keep], R_s[keep], grp[keep]
    corner = np.zeros((n_left, n_right), dtype=np.int64)
    kw = 1 if weight is None else weight[b_s[keep]]
    np.add.at(corner, (kL, kR), kw)
    same = np.nonzero(kg[1:] == kg[:-1])[0]  # consecutive frontier pairs
    if len(same):
        np.add.at(corner, (kL[same + 1], kR[same]), -1 if weight is None else -kw[same])
    support = np.cumsum(np.cumsum(corner[::-1, ::-1], axis=0), axis=1)[
        ::-1, ::-1
    ]
    for start in range(first + 1):
        a = first - start
        for end in range(last, len(lst)):
            count = int(support[a, end - last])
            if count >= threshold:
                sublists[tuple(lst[start : end + 1])] = count
    return sublists


# ----------------------------------------------------------- full path set


def _weighted_gene_index(
    gene_call_subset: dict, multiplicity: dict = None
) -> SequenceIndex:
    """Dedup gene-call sequences into one representative each and return a
    SequenceIndex over the representatives, weighted so get_all_sublists
    counts stay exact.

    gene_call_subset holds every read twice (read and read_reverse with the
    reversed calls), and support counts one distinct base read per
    fw/rv pair. Groups are therefore unioned whenever they share a base
    read name: a base read's fw and rv sequences land in complementary
    groups, so every base read of a linked component has exactly the same
    occurrence set as the component's representatives — counting each
    component with weight = its distinct base-read count reproduces the
    per-read union-of-rectangles tally."""
    rep_seqs: dict = {}
    rep_of: dict = {}
    seen: dict = {}
    for sid, seq in gene_call_subset.items():
        key = tuple(seq)
        rep = seen.get(key)
        if rep is None:
            seen[key] = rep = sid
            rep_seqs[sid] = list(seq)
        rep_of[sid] = rep
    parent = {rep: rep for rep in rep_seqs}

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    by_base: dict = {}
    root_bases: dict = {}
    for sid, rep in rep_of.items():
        b = str(sid).replace("_reverse", "")
        first = by_base.get(b)
        if first is None:
            by_base[b] = rep
        else:
            ra, rb = find(first), find(rep)
            if ra != rb:
                parent[ra] = rb
    root_weight: dict = {}
    if multiplicity is None:
        for sid, rep in rep_of.items():
            root = find(rep)
            root_bases.setdefault(root, set()).add(
                str(sid).replace("_reverse", "")
            )
        root_weight = {root: len(b) for root, b in root_bases.items()}
    else:
        # pre-deduplicated input: each sid stands for multiplicity[sid]
        # base reads (reverse twins carry 0 — their reads are counted by
        # their forward representative, which shares their base name)
        for sid, rep in rep_of.items():
            root = find(rep)
            root_weight[root] = root_weight.get(root, 0) + multiplicity.get(
                sid, 0
            )
    idx = SequenceIndex(rep_seqs)
    root_id: dict = {}
    weights: list = []
    base_idx = np.empty(len(idx._sids), dtype=np.int64)
    for i, sid in enumerate(idx._sids):
        root = find(sid)
        rid = root_id.get(root)
        if rid is None:
            rid = root_id[root] = len(weights)
            weights.append(root_weight[root])
        base_idx[i] = rid
    idx._base_idx = base_idx
    idx._base_weight = np.asarray(weights, dtype=np.int64)
    return idx


def get_full_paths(
    graph, node_index, nodeAnchors, threshold, gene_call_subset, geneOfInterest,
    gene_multiplicity=None,
):
    """Anchor-pair context discovery -> clustered full paths -> the
    differentiating gene window per block (construct_graph.py:2725-2782)."""
    full_blocks: dict = {}
    ctx_memo: dict = {}
    # per-read anchor positions, shared by every a1 (replaces one reversed-
    # suffix sub-index build per anchor; see process_anchors_from_positions)
    anchor_pos: dict = {}
    for a in nodeAnchors:
        for sid, pos in node_index.posting_pairs(a):
            anchor_pos.setdefault(sid, {}).setdefault(a, []).append(pos)
    for a1 in nodeAnchors:
        process_anchors_from_positions(
            node_index, anchor_pos, nodeAnchors, a1, full_blocks, threshold,
            ctx_memo,
        )
    gene_index = _weighted_gene_index(gene_call_subset, gene_multiplicity)
    gene_blocks: dict = {}
    unitig_gene_cache: dict = {}

    def genes_of(f):
        if f not in unitig_gene_cache:
            unitig_gene_cache[f] = graph.get_genes_in_unitig(list(f))
        return unitig_gene_cache[f]

    sublists_memo: dict = {}
    for f in full_blocks:
        try:
            genes_in_path = genes_of(f)
        except (ValueError, AssertionError, KeyError):
            continue
        gkey = tuple(genes_in_path)
        if gkey not in sublists_memo:
            sublists_memo[gkey] = get_all_sublists(
                gene_index, genes_in_path, threshold, geneOfInterest
            )
        all_sublists = sublists_memo[gkey]
        if len(all_sublists) > 0:
            gene_blocks[f] = all_sublists
    filtered_blocks = filter_blocks({f: full_blocks[f] for f in gene_blocks})
    final_paths: dict = {}
    final_path_coverages: dict = {}
    seen_nodes: set = set()
    for f1 in filtered_blocks:
        seen_nodes.update(f1)
        if f1 not in gene_blocks:
            continue
        differentiating = set()
        for o1 in gene_blocks[f1]:
            if not any(
                is_sublist(genes_of(f2), list(o1))
                or is_sublist(genes_of(f2), graph.reverse_list_of_genes(list(o1)))
                for f2 in filtered_blocks
                if f1 != f2
            ):
                differentiating.add(o1)
        if len(differentiating) > 0:
            selected = sorted(
                list(differentiating),
                key=lambda x: (
                    x.count(f"+{geneOfInterest}") + x.count(f"-{geneOfInterest}"),
                    gene_blocks[f1][x],
                    len(x),
                ),
                reverse=True,
            )[0]
            final_paths[selected] = gene_blocks[f1][selected]
            final_path_coverages[selected] = [
                graph.get_node_by_hash(n).coverage for n in list(f1)
            ]
    return final_paths, seen_nodes, final_path_coverages


def get_singleton_paths(graph, all_seen_nodes, nodeAnchors, final_paths, final_path_coverages):
    for a in nodeAnchors:
        if a not in all_seen_nodes:
            genes = tuple(graph.get_genes_in_unitig([a]))
            node = graph.get_node_by_hash(a)
            final_paths[genes] = len(set(node.reads))
            final_path_coverages[genes] = [node.coverage]


def get_paths_for_gene(
    graph, node_index, gene_call_subset, nodeHashesOfInterest, threshold,
    geneOfInterest, gene_multiplicity=None,
):
    nodeAnchors = get_AMR_anchors(graph, nodeHashesOfInterest)
    final_paths, seen_nodes, final_path_coverages = get_full_paths(
        graph, node_index, nodeAnchors, threshold, gene_call_subset,
        geneOfInterest, gene_multiplicity=gene_multiplicity,
    )
    get_singleton_paths(graph, seen_nodes, nodeAnchors, final_paths, final_path_coverages)
    return final_paths, final_path_coverages


# ------------------------------------------------------------ subpath split


def split_into_subpaths(
    graph, geneOfInterest, pathsOfInterest, path_coverages, path_reads,
    mean_node_coverage=None, candidate_reads=None,
):
    """Name alleles <gene>_<n> per path copy and collect per-read allele
    sequence spans (construct_graph.py:2360-2455)."""
    allele_count = 1
    gene_clusters: dict = {}
    if mean_node_coverage is None:
        mean_node_coverage = graph.get_mean_node_coverage()
    read_tracking: dict = {}
    if candidate_reads is None:
        # every differentiating path contains the gene of interest, so only
        # reads carrying the gene can match it (fw or rc) — prefilter once
        # (assign_reads_to_genes precomputes this for all genes in one pass)
        candidate_reads = [
            read_id
            for read_id, genes in graph.get_reads().items()
            if any(g[1:] == geneOfInterest for g in genes)
        ]
    # one posting-list index over the candidates answers every path's
    # occurrence query; the per-read is_sublist scans were the scale
    # bottleneck (O(paths x reads x len)). Identical gene-call sequences
    # share one representative (occurrence positions depend only on the
    # sequence), so index size and query cost scale with DISTINCT calls.
    reads_map = graph.get_reads()
    cand_rep_seqs: dict = {}
    cand_rep_of: dict = {}
    _seen_seqs: dict = {}
    for r in candidate_reads:
        key = tuple(reads_map[r])
        rep = _seen_seqs.get(key)
        if rep is None:
            _seen_seqs[key] = rep = r
            cand_rep_seqs[r] = reads_map[r]
        cand_rep_of[r] = rep
    cand_index = SequenceIndex(cand_rep_seqs)
    for path in pathsOfInterest:
        modified_path = list(path)
        genes_in_path = list(path)
        reverse_genes_in_path = graph.reverse_list_of_genes(genes_in_path)
        fw_indices: dict = {}
        rv_indices: dict = {}
        for g in range(len(genes_in_path)):
            if genes_in_path[g][1:] == geneOfInterest:
                name = f"{geneOfInterest}_{allele_count}"
                fw_indices[g] = name
                rv_indices[len(genes_in_path) - g - 1] = name
                gene_clusters[name] = []
                read_tracking[name] = set()
                modified_path[g] = f"{genes_in_path[g][0]}{name}"
                allele_count += 1
        modified_path = tuple(modified_path)
        m = len(genes_in_path)
        fw_occ: dict = {}
        for sid, st in cand_index.find_all(genes_in_path):
            fw_occ.setdefault(sid, []).append((st, st + m - 1))
        rv_occ: dict = {}
        for sid, st in cand_index.find_all(reverse_genes_in_path):
            rv_occ.setdefault(sid, []).append((st, st + m - 1))
        if not fw_occ and not rv_occ:
            continue
        for read_id in candidate_reads:
            rep = cand_rep_of[read_id]
            if rep in fw_occ:
                positions_of_path = fw_occ[rep]
                indices_in_path = fw_indices
            elif rep in rv_occ:
                positions_of_path = rv_occ[rep]
                indices_in_path = rv_indices
            else:
                continue
            if len(positions_of_path) == 1:
                if modified_path not in path_reads:
                    path_reads[modified_path] = set()
                path_reads[modified_path].add(read_id)
                for path_start, _path_end in positions_of_path:
                    for gene_index in indices_in_path:
                        assert (
                            graph.get_reads()[read_id][path_start + gene_index][1:]
                            == geneOfInterest
                        )
                        seq_start, seq_end = graph.get_gene_positions()[read_id][
                            path_start + gene_index
                        ]
                        tag = f"{read_id}_{seq_start}_{seq_end}"
                        gene_clusters[indices_in_path[gene_index]].append(tag)
                        read_tracking[indices_in_path[gene_index]].add(tag)
    sorted_alleles = sorted(
        [a for a in read_tracking], key=lambda x: len(read_tracking[x]), reverse=True
    )
    to_delete = set()
    for i in range(len(sorted_alleles)):
        a1 = sorted_alleles[i]
        if a1 in to_delete:
            continue
        for a2 in sorted_alleles[i + 1 :]:
            if a1 == a2:
                continue
            if len(read_tracking[a1] & read_tracking[a2]) > 0:
                to_delete.add(a2)
    for d in to_delete:
        del gene_clusters[d]
    return gene_clusters, path_reads


# ------------------------------------------------------- component assembly


def assign_final_alleles_to_components(
    graph, finalAllelesOfInterest, clustered_reads, allele_counts, geneOfInterest
):
    """Place each final allele's member list into the component of its
    FIRST member's first live graph node, numbering alleles per gene
    (behavioral contract: construct_graph.py:2784-2807 — including the
    first-member-only component probe)."""
    read_nodes = graph.get_readNodes()
    live = graph.get_nodes()
    for allele, members in finalAllelesOfInterest.items():
        component = None
        if members:
            src = "_".join(members[0].split("_")[:-2])
            component = next(
                (
                    graph.get_node_by_hash(h).component
                    for h in read_nodes[src]
                    if h is not None and h in live
                ),
                None,
            )
        # NB: an underscore-free name maps to "" (the upstream quirk)
        gene_name = "_".join(allele.split("_")[:-1])
        n = allele_counts.setdefault(gene_name, 1)
        bucket = clustered_reads.setdefault(component, {}).setdefault(
            geneOfInterest, {}
        )
        bucket[f"{gene_name}_{n}"] = members
        allele_counts[gene_name] = n + 1


def collect_component_missed_genes(
    graph, component_nodeHashesOfInterest, clustered_reads, allele_counts,
    geneOfInterest, path_reads,
):
    """Sweep up AMR genes that got no path cluster in a component: every
    component whose gene bucket stayed empty receives one synthetic
    allele holding all of that gene's spans on the component's reads
    (behavioral contract: construct_graph.py:2831-2878 — allele naming,
    span-string format, and path_reads support sets)."""
    reads_map = graph.get_reads()
    positions_map = graph.get_gene_positions()
    for component, node_hashes in component_nodeHashesOfInterest.items():
        by_gene = clustered_reads.setdefault(component, {})
        bucket = by_gene.setdefault(geneOfInterest, {})
        if bucket:
            continue  # the path clustering already covered this component
        n = allele_counts.setdefault(geneOfInterest, 1)
        allele_name = f"{geneOfInterest}_{n}"
        spans = bucket[allele_name] = []
        reads = graph.collect_reads_in_path(node_hashes)
        if reads:
            support = path_reads.setdefault((f"+{allele_name}",), set())
        for read_id in reads:
            pos = positions_map[read_id]
            spans.extend(
                f"{read_id}_{pos[i][0]}_{pos[i][1]}"
                for i, g in enumerate(reads_map[read_id])
                if g[1:] == geneOfInterest
            )
            support.add(read_id)
        allele_counts[geneOfInterest] = n + 1


def assign_reads_to_genes(
    graph, listOfGenes, cores=1, allele_counts=None, mean_node_coverage=None,
    path_threshold=5,
):
    """Per-AMR-gene read->allele clustering (construct_graph.py:2880-2939).

    Under an open phase each gene with graph nodes adds one to the counter
    `genes` and opens three spans: `cluster.gene_paths` (its node and
    gene-call indexes and `get_paths_for_gene`; counter `paths`),
    `cluster.split` (`split_into_subpaths`; counter `alleles`, those kept)
    and `cluster.components` (placing the alleles in components and the
    sweep of components left without one)."""
    if allele_counts is None:
        allele_counts = {}
    clustered_reads: dict = {}
    path_reads: dict = {}
    if mean_node_coverage is None:
        mean_node_coverage = graph.get_mean_node_coverage()
    # one pass over all reads collects every gene's subpath candidates
    # (same order and content as split_into_subpaths' per-gene prefilter)
    genes_wanted = set(listOfGenes)
    rc_cache: dict = {}  # gene-seq tuple -> reversed gene list, shared across genes
    candidates_by_gene: dict = {g: [] for g in genes_wanted}
    for read_id, genes in graph.get_reads().items():
        seen_here = set()
        for g in genes:
            base = g[1:]
            if base in genes_wanted and base not in seen_here:
                seen_here.add(base)
                candidates_by_gene[base].append(read_id)
    for geneOfInterest in sorted(listOfGenes):
        nodesOfInterest = graph.get_nodes_containing(geneOfInterest)
        nodeHashesOfInterest = [n.hash for n in nodesOfInterest]
        if not nodeHashesOfInterest:
            continue
        TIMER.count("genes")
        with TIMER.span("cluster.gene_paths"):
            reads_with_gene = graph.collect_reads_in_path(nodeHashesOfInterest)
            node_index = construct_node_index(
                {r: graph.get_readNodes()[r] for r in reads_with_gene}
            )
            # dedup the gene-call subset ahead of the index build: one
            # representative (and its reverse) per distinct call sequence,
            # with its read count as the support weight — sublist support
            # counting then scales with distinct sequences, not reads
            reads_map = graph.get_reads()
            call_groups: dict = {}
            for r in reads_with_gene:
                call_groups.setdefault(tuple(reads_map[r]), []).append(r)
            gene_call_subset: dict = {}
            gene_multiplicity: dict = {}
            for key, mem in call_groups.items():
                rep = mem[0]
                rv = rc_cache.get(key)
                if rv is None:
                    rv = graph.reverse_list_of_genes(list(key))
                    rc_cache[key] = rv
                gene_call_subset[rep] = list(key)
                gene_call_subset[rep + "_reverse"] = rv
                gene_multiplicity[rep] = len(mem)
            pathsOfInterest, pathCoverages = get_paths_for_gene(
                graph,
                node_index,
                gene_call_subset,
                nodeHashesOfInterest,
                mean_node_coverage / 20,
                geneOfInterest,
                gene_multiplicity=gene_multiplicity,
            )
            TIMER.count("paths", len(pathsOfInterest))
        with TIMER.span("cluster.split"):
            finalAllelesOfInterest, path_reads = split_into_subpaths(
                graph, geneOfInterest, pathsOfInterest, pathCoverages, path_reads,
                mean_node_coverage,
                candidate_reads=candidates_by_gene[geneOfInterest],
            )
            TIMER.count("alleles", len(finalAllelesOfInterest))
        with TIMER.span("cluster.components"):
            assign_final_alleles_to_components(
                graph, finalAllelesOfInterest, clustered_reads, allele_counts,
                geneOfInterest,
            )
            component_nodeHashesOfInterest: dict = {}
            for n in nodeHashesOfInterest:
                comp = graph.get_node_by_hash(n).component
                component_nodeHashesOfInterest.setdefault(comp, set()).add(n)
            collect_component_missed_genes(
                graph, component_nodeHashesOfInterest, clustered_reads,
                allele_counts, geneOfInterest, path_reads,
            )
    return clustered_reads, path_reads
