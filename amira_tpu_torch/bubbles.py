"""Bubble popping: correct lower-coverage alternative paths onto their
higher-coverage twins.

Reference semantics: amira/construct_graph.py:1482-2265. Junction nodes
(out-degree > 1 in either orientation) seed a bounded path enumeration; path
pairs sharing terminals whose read-sequence minimizer containment exceeds
0.80 define correction operations; affected reads have the low-coverage gene
segment spliced out via gene-symbol alignments. AMR genes are never deleted
by a correction (construct_graph.py:1877-1881). Unlike the reference, a read
is corrected only where it holds the lower path's whole difference from the
higher one (`correct_bubble_paths`).
"""

from __future__ import annotations

import time
from collections import Counter

import numpy as np

from .correct import needleman_wunsch, replace_invalid_gene_positions
from .sketch import MinHash
from .stree import SequenceIndex
from .tracing import TIMER



# --------------------------------------------------------------- primitives


def calculate_path_coverage(graph, path):
    """Mean coverage of the interior nodes of a (hash, dir) path."""
    return float(
        np.mean([graph.get_node_by_hash(n[0]).coverage for n in path[1:-1]])
    )


def identify_potential_bubble_starts(graph):
    out: dict = {}
    for node in graph.all_nodes():
        if len(node.fwd_edges) > 1:
            out.setdefault(node.component, []).append((node.hash, 1))
        if len(node.bwd_edges) > 1:
            out.setdefault(node.component, []).append((node.hash, -1))
    return out


def find_paths_to_junctions(graph, start_hash, start_dir, junctions, distance):
    """One bounded DFS from (start, dir) collecting every simple path that
    lands on any junction in `junctions`, grouped by the end node.

    Equivalent to running graph.new_find_paths_between_nodes once per
    ordered (start, stop) junction pair (construct_graph.py:2292-2342) —
    the per-pair searches traverse identical trees and differ only in where
    they record, so a single traversal that records at every junction yields
    exactly the union — at 1/J the cost for J junctions."""
    results: dict = {}
    nodes = graph.get_nodes()
    edges = graph.get_edges()
    # explicit-backtrack DFS: one shared path list + on-path set, copied
    # only when a path is recorded (the naive per-push path/set copies were
    # the sweep's dominant allocation cost)
    path: list = []
    seen: set = set()
    _POP = object()
    stack = [(start_hash, start_dir)]
    while stack:
        item = stack.pop()
        if item is _POP:
            seen.discard(path.pop()[0])
            continue
        h, d = item
        path.append((h, d))
        seen.add(h)
        stack.append(_POP)
        if h != start_hash and h in junctions and len(path) <= distance:
            results.setdefault(h, []).append(list(path))
        if len(path) - 1 > distance:
            continue
        node = nodes.get(h)
        if node is None:
            continue
        edge_keys = node.fwd_edges if d == 1 else node.bwd_edges if d == -1 else []
        for key in edge_keys:
            edge = edges[key]
            nxt = edge.tgt
            if nxt in seen:
                continue
            stack.append((nxt, edge.tgt_dir))
    return results


def _get_all_paths_scalar(graph, bubble_starts, max_distance):
    """Reference implementation: one DFS per start (kept as the parity
    oracle for the vectorized frontier search below)."""
    unique_paths = set()
    junction_hashes = {h for h, _d in bubble_starts}
    stop_dirs: dict = {}
    for h, d in bubble_starts:
        stop_dirs.setdefault(h, []).append(d)
    for start_hash, start_dir in bubble_starts:
        by_stop = find_paths_to_junctions(
            graph, start_hash, start_dir, junction_hashes, max_distance
        )
        for stop_hash, paths in by_stop.items():
            if stop_hash == start_hash:
                continue
            evaluated = [
                (p, graph.get_direction_between_two_nodes(p[-2][0], p[-1][0]))
                for p in paths
                if len(p) >= 2
            ]
            for stop_dir in stop_dirs[stop_hash]:
                valid = [p for p, end_dir in evaluated if end_dir == stop_dir]
                if len(valid) > 1:
                    for p in valid:
                        rc = list(reversed([(t[0], t[1] * -1) for t in p]))
                        unique_paths.add(tuple(sorted([p, rc])[0]))
    return list(unique_paths)


def get_all_paths_between_junctions_in_component(
    graph, bubble_starts, max_distance, return_rows=False,
    return_matrices=False,
):
    """All direction-consistent simple paths (>1 alternative) between ordered
    junction pairs, canonicalized (construct_graph.py:2066-2098).

    Implemented as ONE batched frontier expansion over a CSR successor
    table covering every start simultaneously — each frontier level is a
    handful of numpy array ops over (paths x depth) matrices instead of a
    per-path Python DFS (the DFS was the cleaning cycle's largest host
    loop: ~half the 100k-read bubble-sweep wall-clock). Same answers as
    `_get_all_paths_scalar` (pinned by tests/test_bubble_path_search.py):
    path simplicity, the <= max_distance record window, per-(start, stop,
    end-dir) multiplicity > 1, first-edge end-direction lookup, and
    reverse-complement canonicalization all preserved."""
    if not bubble_starts:
        if return_matrices:
            return [], []
        return ([], {}) if return_rows else []
    nodes = graph.get_nodes()
    edges = graph.get_edges()
    junction_hashes = {h for h, _d in bubble_starts}
    stop_dirs: dict = {}
    for h, d in bubble_starts:
        stop_dirs.setdefault(h, []).append(d)

    # ---- CSR successor table over (node, dir) states
    hash_list = list(nodes.keys())
    idx_of = {h: i for i, h in enumerate(hash_list)}
    n = len(hash_list)
    succ_lists: list[list] = [[] for _ in range(2 * n)]
    for h, node in nodes.items():
        hi = idx_of[h]
        for d, keys in ((1, node.fwd_edges), (-1, node.bwd_edges)):
            lst = succ_lists[hi * 2 + (1 if d == 1 else 0)]
            for key in keys:
                e = edges[key]
                t = idx_of.get(e.tgt)
                if t is not None:
                    lst.append(t * 2 + (1 if e.tgt_dir == 1 else 0))
    deg = np.fromiter(
        (len(s) for s in succ_lists), dtype=np.int64, count=2 * n
    )
    ptr = np.zeros(2 * n + 1, np.int64)
    np.cumsum(deg, out=ptr[1:])
    # states fit int32 (node counts are thousands); the frontier matrices
    # reach millions of rows at 500k-read coverage, so element width is
    # directly memory bandwidth
    flat_succ = np.fromiter(
        (s for lst in succ_lists for s in lst),
        dtype=np.int32,
        count=int(ptr[-1]),
    )
    is_junction = np.zeros(n, bool)
    for h in junction_hashes:
        i = idx_of.get(h)
        if i is not None:
            is_junction[i] = True

    # ---- frontier: rows of states (node*2 + dirbit), one per live path
    starts_arr = np.fromiter(
        (
            idx_of[h] * 2 + (1 if d == 1 else 0)
            for h, d in bubble_starts
            if h in idx_of
        ),
        dtype=np.int32,
    )
    frontier = starts_arr[:, None]  # (P, depth) state rows
    start_of = np.arange(len(starts_arr))  # index into bubble_starts
    recorded: list = []  # (depth-level path matrices, start indices)
    # the scalar DFS expands paths up to max_distance + 1 nodes but only
    # RECORDS paths of <= max_distance nodes, and the extra level's
    # children are never recorded either — so levels past max_distance
    # contribute nothing and are skipped entirely
    for depth in range(2, max_distance + 1):
        if frontier.shape[0] == 0:
            break
        tips = frontier[:, -1]
        reps = deg[tips]
        total = int(reps.sum())
        if total == 0:
            break
        rows = np.repeat(np.arange(frontier.shape[0]), reps)
        offs = np.concatenate([[0], np.cumsum(reps)[:-1]])
        within = np.arange(total) - np.repeat(offs, reps)
        child = flat_succ[np.repeat(ptr[tips], reps) + within]
        # simplicity: the child NODE must not already be on the path
        cand = frontier[rows]
        simple = ~np.any((cand >> 1) == (child[:, None] >> 1), axis=1)
        cand = cand[simple]
        child = child[simple]
        frontier = np.concatenate([cand, child[:, None]], axis=1)
        start_of = start_of[rows[simple]]
        rec = is_junction[frontier[:, -1] >> 1]
        if rec.any():
            recorded.append((frontier[rec], start_of[rec]))

    if not recorded:
        if return_matrices:
            return [], hash_list
        return ([], {}) if return_rows else []
    # ---- end-direction per row: the SAME first-edge lookup as the scalar
    # path, but called once per distinct (prev, stop) node pair; rows map
    # through the pair table vectorized
    hash_arr = np.array(hash_list, dtype=np.uint64)
    stop_plus = np.zeros(n, bool)
    stop_minus = np.zeros(n, bool)
    for h, ds in stop_dirs.items():
        i = idx_of.get(h)
        if i is not None:
            stop_plus[i] = 1 in ds
            stop_minus[i] = -1 in ds
    # canonical-order rank of each (node, dirbit) state under the Python
    # tuple ordering (hash first, then dir with -1 < +1 == bit 0 < 1);
    # int32: state counts are at most millions, and the rank matrices
    # reach (paths x depth) — element width is memory bandwidth
    state_hash = np.repeat(hash_arr, 2)
    state_bit = np.tile(np.array([0, 1], np.int64), n)
    order = np.lexsort((state_bit, state_hash))
    rank = np.empty(2 * n, np.int32)
    rank[order] = np.arange(2 * n, dtype=np.int32)

    level_keys = []
    level_rows = []
    dir_memo: dict = {}
    for mat, st in recorded:
        stop_idx = (mat[:, -1] >> 1).astype(np.int64)
        prev_idx = (mat[:, -2] >> 1).astype(np.int64)
        pair = prev_idx * n + stop_idx
        uniq_pairs, inv = np.unique(pair, return_inverse=True)
        ed_of_pair = np.empty(len(uniq_pairs), np.int64)
        for j, pc in enumerate(uniq_pairs.tolist()):
            v = dir_memo.get(pc)
            if v is None:
                v = graph.get_direction_between_two_nodes(
                    hash_list[pc // n], hash_list[pc % n]
                )
                dir_memo[pc] = v
            ed_of_pair[j] = v
        ed = ed_of_pair[inv]
        ok = np.where(
            ed == 1, stop_plus[stop_idx], stop_minus[stop_idx]
        )
        keep = np.nonzero(ok)[0]
        # group key: (start index, stop node, end dir)
        level_keys.append(
            (st[keep].astype(np.int64) * n + stop_idx[keep]) * 2
            + (ed[keep] == 1)
        )
        level_rows.append(mat[keep])
    all_keys = np.concatenate(level_keys)
    if len(all_keys) == 0:
        if return_matrices:
            return [], hash_list
        return ([], {}) if return_rows else []
    uk, inv, counts = np.unique(
        all_keys, return_inverse=True, return_counts=True
    )
    multi = counts[inv] > 1  # a path is valid iff its group has > 1 path
    # packed-key width: every state fits `bits`, so `per` states pack into
    # one uint64 sort key — the per-column lexsort re-scanned every row
    # once per depth column and dominated the 500k path search
    bits = int((2 * n)).bit_length()
    per = max(1, 64 // bits)
    levels_out: list = []
    pos = 0
    for mat in level_rows:
        m = multi[pos : pos + mat.shape[0]]
        pos += mat.shape[0]
        mat = mat[m]
        if mat.shape[0] == 0:
            continue
        # canonicalize each row against its reverse-complement (columns
        # reversed, direction bit flipped) under the hash-order rank, then
        # dedup rows — all without per-path Python
        rr = rank[mat]
        rc_mat = mat[:, ::-1] ^ 1
        rcr = rank[rc_mat]
        diff = rr != rcr
        first = np.argmax(diff, axis=1)
        rows_i = np.arange(mat.shape[0])
        take_rc = diff.any(axis=1) & (
            rcr[rows_i, first] < rr[rows_i, first]
        )
        canon = np.where(take_rc[:, None], rc_mat, mat)
        # row dedup via lexsort over PACKED uint64 keys (identical order
        # to column-lexicographic since all values < 2^bits): ~3x fewer
        # sort passes than one per depth column, and np.unique(axis=0)'s
        # void-dtype round-trip was slower still
        P, D = canon.shape
        K = (D + per - 1) // per
        keys = np.empty((P, K), np.uint64)
        for kk in range(K):
            seg = canon[:, kk * per : (kk + 1) * per].astype(np.uint64)
            acc = np.zeros(P, np.uint64)
            for c in range(per):
                acc <<= np.uint64(bits)
                if c < seg.shape[1]:
                    acc |= seg[:, c]
            keys[:, kk] = acc
        order = np.lexsort(tuple(keys[:, kk] for kk in range(K - 1, -1, -1)))
        ks = keys[order]
        keep_row = np.concatenate(
            [[True], (ks[1:] != ks[:-1]).any(axis=1)]
        )
        levels_out.append(canon[order][keep_row])
    if return_matrices:
        # fast path: the containment filter consumes the int32 rows and
        # materializes tuples for survivors only (>99% of paths drop)
        return levels_out, hash_list
    out: list = []
    row_of: dict = {}
    for canon in levels_out:
        for ri, row in enumerate(canon.tolist()):
            t = tuple(
                (hash_list[s >> 1], 1 if (s & 1) else -1) for s in row
            )
            out.append(t)
            if return_rows:
                row_of[t] = canon[ri]
    # legacy tuple API (oracle/parity tests): preserve the historical
    # set-round-trip ordering
    result = list(set(out))
    if return_rows:
        return result, row_of
    return result


def _filter_paths_scalar(graph, unique_paths):
    """Reference implementation of the containment filter (kept as the
    parity oracle for the batched screen below)."""
    unique_paths = sorted(list(unique_paths), key=len)
    index = SequenceIndex({i: list(p) for i, p in enumerate(unique_paths)})
    filtered = []
    targets = set()
    for i, p in enumerate(unique_paths):
        if i in targets:
            continue
        p_list = list(p)
        res = index.find_ids(p_list)
        rv_res = index.find_ids(list(reversed(p_list)))
        for j in res | rv_res:
            if i != j:
                targets.add(j)
        if len(p) > 2:
            filtered.append((p, calculate_path_coverage(graph, p)))
    return filtered


def filter_paths_between_bubble_starts(graph, unique_paths, path_rows=None):
    """Drop paths that contain shorter paths; keep paths of > 2 nodes with
    their interior coverage (construct_graph.py:2125-2146).

    The containment relation is transitively closed under contiguity, so
    the scalar pass's marked-paths-don't-mark rule is inert and the filter
    reduces to: drop p iff some OTHER path q (forward or reversed, no
    strand flip) occurs contiguously inside p. Screened with ONE batched
    rolling-hash pass per query length over the padded path matrix —
    random-weight 64-bit window hashes, exact row verification on every
    hit — instead of a per-path posting-index query (which was half the
    500k-read bubble-sweep wall-clock). Same answers as
    `_filter_paths_scalar` (pinned by tests/test_bubbles.py).

    `path_rows` (optional): {path_tuple: int32 state row} from the frontier
    search — reused directly as the token matrix, skipping the per-element
    re-interning pass."""
    unique_paths = sorted(list(unique_paths), key=len)
    n_paths = len(unique_paths)
    if n_paths == 0:
        return []
    import os as _os

    _dump = _os.environ.get("AMIRA_TPU_DUMP_PATHS")
    if _dump:
        import pickle

        with open(_dump, "ab") as fh:
            pickle.dump(unique_paths, fh)
    lens = np.fromiter((len(p) for p in unique_paths), np.int64, n_paths)
    Lmax = int(lens.max())
    if path_rows is not None:
        # tokens = frontier search states (already injective per symbol)
        mat = np.full((n_paths, Lmax), -1, np.int64)
        for i, p in enumerate(unique_paths):
            r = path_rows[p]
            mat[i, : len(r)] = r
        n_sym = int(mat.max()) + 1
        mat[mat < 0] = n_sym
    else:
        # intern (hash, dir) pair symbols exactly like stree.SequenceIndex
        flat_a = np.fromiter(
            (s[0] for p in unique_paths for s in p), np.uint64,
            int(lens.sum()),
        )
        flat_b = np.fromiter(
            (s[1] for p in unique_paths for s in p), np.int64,
            int(lens.sum()),
        )
        order = np.lexsort((flat_b, flat_a))
        sa, sb = flat_a[order], flat_b[order]
        boundary = np.concatenate(
            [[True], (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1])]
        )
        tok = np.empty(len(flat_a), np.int64)
        tok[order] = np.cumsum(boundary) - 1
        n_sym = int(boundary.sum())
        # padded token matrix; pad symbol never matches a real window
        mat = np.full((n_paths, Lmax), n_sym, np.int64)
        offs = np.concatenate([[0], np.cumsum(lens)])
        total = int(offs[-1])
        within = np.arange(total) - np.repeat(offs[:-1], lens)
        mat.reshape(-1)[
            np.repeat(np.arange(n_paths) * Lmax, lens) + within
        ] = tok
    dropped = _containment_drop_mask(mat, lens, n_sym)
    # coverage via one dict of node coverages (the per-path attribute
    # chases through graph objects tripled the output cost); np.mean over
    # the same Python list keeps the float result bit-identical
    cov_of: dict = {}
    out = []
    for i, p in enumerate(unique_paths):
        if dropped[i] or len(p) <= 2:
            continue
        vals = []
        for nd in p[1:-1]:
            h = nd[0]
            c = cov_of.get(h)
            if c is None:
                c = graph.get_node_by_hash(h).coverage
                cov_of[h] = c
            vals.append(c)
        out.append((p, float(np.mean(vals))))
    return out


def filter_path_matrices(graph, levels, hash_list):
    """Containment filter straight on the frontier search's canonical
    int32 row matrices (the production sweep path): identical answers to
    `filter_paths_between_bubble_starts`, but path tuples materialize for
    SURVIVORS only — on 500k-read sweeps >99% of paths drop, and the
    per-path Python tuple materialization alone cost ~9s/sweep."""
    n_paths = sum(lv.shape[0] for lv in levels)
    if n_paths == 0:
        return []
    Lmax = max(lv.shape[1] for lv in levels)
    mat = np.full((n_paths, Lmax), -1, np.int64)
    lens = np.empty(n_paths, np.int64)
    pos = 0
    for lv in levels:  # levels ascend in depth == rows sorted by length
        P, D = lv.shape
        mat[pos : pos + P, :D] = lv
        lens[pos : pos + P] = D
        pos += P
    n_sym = int(mat.max()) + 1
    mat[mat < 0] = n_sym
    dropped = _containment_drop_mask(mat, lens, n_sym)
    cov_of: dict = {}
    out = []
    for i in np.nonzero(~dropped & (lens > 2))[0].tolist():
        row = mat[i, : lens[i]].tolist()
        p = tuple(
            (hash_list[s >> 1], 1 if (s & 1) else -1) for s in row
        )
        vals = []
        for h, _d in p[1:-1]:
            c = cov_of.get(h)
            if c is None:
                c = graph.get_node_by_hash(h).coverage
                cov_of[h] = c
            vals.append(c)
        out.append((p, float(np.mean(vals))))
    return out


def _containment_drop_mask(mat, lens, n_sym):
    """Shared core of the batched containment screen: drop path i iff some
    OTHER path (forward or plain-reversed) occurs contiguously inside it.
    `mat` is the padded symbol matrix sorted by ascending row length with
    pad symbol n_sym; returns the boolean drop mask."""
    n_paths = mat.shape[0]
    Lmax = mat.shape[1]
    rng = np.random.RandomState(0xA31)
    sym_rand = rng.randint(0, 2**32, size=n_sym + 1, dtype=np.uint64).astype(
        np.uint32
    )
    rmat = sym_rand[mat]
    # prefix polynomial hash: H(window at o, len L) =
    #   (pref[o+L] - pref[o]) * B^-o  with B odd (invertible mod 2^32) —
    # every window of every length comes from ONE cumsum, O(1) apiece (a
    # per-length windowed dot product re-scanned the whole matrix per
    # length class and was SLOWER than the posting index it replaced).
    # 32-bit lanes: the screen only SHORTLISTS — every hash hit gets an
    # exact row verification below, so collisions cost retries, never
    # answers, and halving the element width halves this loop's memory
    # traffic (it runs at host bandwidth). Powers in Python ints mod 2^32
    # (numpy would warn on the intended wraparound).
    B = 0x9E3779B1 | 1
    Binv = pow(B, -1, 1 << 32)
    Bpow = np.array(
        [pow(B, j, 1 << 32) for j in range(Lmax + 1)], dtype=np.uint32
    )
    Binv_pow = np.array(
        [pow(Binv, j, 1 << 32) for j in range(Lmax + 1)], dtype=np.uint32
    )
    pref = np.zeros((n_paths, Lmax + 1), np.uint32)
    np.cumsum(rmat * Bpow[None, :Lmax], axis=1, out=pref[:, 1:])
    dropped = np.zeros(n_paths, bool)
    by_len: dict = {}
    for i in range(n_paths):
        by_len.setdefault(int(lens[i]), []).append(i)

    # process query lengths ascending with the HOST set shrinking as paths
    # drop — on real 500k sweeps >99% of paths die to the shortest queries,
    # so later classes hash a few thousand rows instead of hundreds of
    # thousands
    alive = np.arange(n_paths)
    for Lq, q_idx in sorted(by_len.items()):
        q_idx_arr = np.asarray(q_idx)
        # query hashes at offset 0: forward, and plain reversal (no dir
        # flip) hashed directly from the reversed token rows
        q_hash = pref[q_idx_arr, Lq] - pref[q_idx_arr, 0]
        qrows_r = rmat[q_idx_arr, :Lq][:, ::-1]
        qr_hash = (qrows_r * Bpow[None, :Lq]).sum(axis=1, dtype=np.uint32)
        # candidate table sorted by hash for vectorized first-match lookup
        q_all_hash = np.concatenate([q_hash, qr_hash])
        q_all_ids = np.concatenate([q_idx_arr, q_idx_arr])
        qfwd = mat[q_idx_arr, :Lq]
        q_all_rows = np.concatenate([qfwd, qfwd[:, ::-1]], axis=0)
        qord = np.argsort(q_all_hash, kind="stable")
        qs_hash = q_all_hash[qord]
        qs_ids = q_all_ids[qord]
        qs_rows = q_all_rows[qord]
        hosts = alive[lens[alive] >= Lq]
        if len(hosts) == 0:
            continue
        W = Lmax - Lq + 1
        ph = pref[hosts]
        whash = (ph[:, Lq:] - ph[:, :-Lq]) * Binv_pow[None, :W]
        flat = whash.reshape(-1)
        lo = np.searchsorted(qs_hash, flat, side="left")
        loc = np.clip(lo, 0, len(qs_hash) - 1)
        hit = (qs_hash[loc] == flat).reshape(len(hosts), W)
        hit &= (np.arange(W)[None, :] + Lq) <= lens[hosts][:, None]
        hp, hw = np.nonzero(hit)
        if len(hp) == 0:
            continue
        host_ids = hosts[hp]
        cand0 = loc.reshape(len(hosts), W)[hp, hw]
        # vectorized verification against the FIRST candidate sharing the
        # hash; ties/self-matches/collisions fall to a tiny scalar pass
        wins = mat[host_ids[:, None], hw[:, None] + np.arange(Lq)[None, :]]
        ok_rows = (wins == qs_rows[cand0]).all(axis=1)
        qid0 = qs_ids[cand0]
        tie_ok = (Lq < lens[host_ids]) | (qid0 < host_ids)
        verified = ok_rows & tie_ok & (qid0 != host_ids)
        dropped[host_ids[verified]] = True
        # residual hits whose first candidate was self / tie-blocked / a
        # collision: walk the candidate run scalar (rare)
        resid = np.nonzero(~verified)[0]
        for ridx in resid.tolist():
            host = int(host_ids[ridx])
            if dropped[host]:
                continue
            wi = int(hw[ridx])
            window = mat[host, wi : wi + Lq]
            ci = int(cand0[ridx])
            h = int(whash[hp[ridx], hw[ridx]])
            while ci < len(qs_hash) and int(qs_hash[ci]) == h:
                q_id = int(qs_ids[ci])
                # equal lengths only match as mutual reversal pairs; the
                # scalar pass keeps whichever sorts first and drops the
                # other, so the later index loses the tie
                if (
                    q_id != host
                    and (Lq < lens[host] or q_id < host)
                    and np.array_equal(window, qs_rows[ci])
                ):
                    dropped[host] = True
                    break
                ci += 1
        alive = alive[~dropped[alive]]
    return dropped


def separate_paths_by_terminal_nodes(sorted_filtered_paths):
    binned: dict = {}
    for p in sorted_filtered_paths:
        terminals = tuple(sorted([p[0][0][0], p[0][-1][0]]))
        binned.setdefault(terminals, []).append(p)
    return {
        key: value
        for key, value in sorted(
            binned.items(),
            key=lambda x: max(len(path[0]) for path in x[1]),
            reverse=True,
        )
    }


# -------------------------------------------------------------- minimizers


def get_minhashes_for_paths(graph, sorted_filtered_paths, fastq_data):
    """Per-path list of per-node read-subsequence sketches
    (construct_graph.py:2148-2194).

    Read sequences are immutable for a run, so each read is hashed ONCE
    (sketch.read_kept_kmer_index, cached on the run-long build cache) and a
    node sketch is the unique union of position-range lookups over its
    (read, span) occurrences; unchanged nodes additionally reuse their
    finished sketch via an exact (read, span)-list fingerprint.
    Byte-identical to per-slice MinHash.add_sequence."""
    from .sketch import (
        batch_read_kept_kmer_index,
        read_kept_kmer_index,
        span_hashes,
    )

    node_minhashes: dict = {}
    path_minimizers: dict = {}
    for path_tuple, _cov in sorted_filtered_paths:
        nodes = [p[0] for p in path_tuple]
        for h in nodes:
            node_minhashes.setdefault(h, None)
        path_minimizers[tuple(nodes)] = []
    import numpy as np

    cache_obj = getattr(graph, "_cache", None)
    store = None
    read_index: dict = {}
    if cache_obj is not None:
        store = getattr(cache_obj, "node_sketches", None)
        if store is None:
            store = {}
            cache_obj.node_sketches = store
        read_index = getattr(cache_obj, "read_kmer_index", None)
        if read_index is None:
            read_index = {}
            cache_obj.read_kmer_index = read_index
    read_nodes_map = graph.get_readNodes()
    positions_map = graph.get_readNodePositions()
    # collect every node's spans first, then hash ALL missing reads in one
    # vectorized pass (the one-call-per-read path dominated the sweep's
    # sketch stage on its first pass over a read set). Each read's node
    # list is digested ONCE into per-node occurrence spans and shared by
    # every node containing it — the per-(node, read) rescan was
    # O(node incidences x read length). Span order (node.reads order,
    # then position order) is unchanged, so the persistent fingerprint
    # cache keeps hitting across builds.
    needed = set(node_minhashes)
    occ_of_read: dict = {}

    def _occ(read):
        o = occ_of_read.get(read)
        if o is None:
            rn = read_nodes_map[read]
            pos = positions_map[read]
            o = {}
            for i, nh in enumerate(rn):
                if nh in needed and pos[i] is not None:
                    o.setdefault(nh, []).append(pos[i])
            occ_of_read[read] = o
        return o

    spans_of: dict = {}
    missing: dict = {}
    for h in node_minhashes:
        node = graph.get_node_by_hash(h)
        spans = []
        for read in node.reads:
            for p in _occ(read).get(h, ()):
                spans.append((read, p[0], p[1]))
        fp = tuple(spans)
        cached = store.get(h) if store is not None else None
        if cached is not None and cached[0] == fp:
            continue  # fingerprint hit; resolved in the loop below
        spans_of[h] = spans
        for read, _s, _e in spans:
            if read not in read_index and read not in missing:
                missing[read] = fastq_data[read]["sequence"]
    if missing:
        read_index.update(
            batch_read_kept_kmer_index(missing, ksize=11, scaled=10)
        )
    # resolve fingerprint hits, then assemble the remaining node sketches
    # span by span (a fully-global searchsorted + gather variant was
    # tried and ran SLOWER: its flattened hash stream materialized ~GB of
    # int64 temporaries on this host; the per-span slice extraction is
    # cheap — np.unique per node is the floor either way)
    for h in node_minhashes:
        if h not in spans_of:
            hit = store.get(h) if store is not None else None
            if hit is not None:
                node_minhashes[h] = hit[1]
                continue
            spans_of[h] = []  # unreachable; defensive
        spans = spans_of[h]
        parts = []
        for read, s, e in spans:
            idx = read_index.get(read)
            if idx is None:
                idx = read_index[read] = read_kept_kmer_index(
                    fastq_data[read]["sequence"], ksize=11, scaled=10
                )
            parts.append(span_hashes(idx, s, e, ksize=11))
        mh = MinHash(ksize=11, scaled=10)
        if parts:
            # sorted distinct array; the Python set materializes only if
            # a set consumer asks (MinHash.hashes) — the batched
            # containment pass below works on the arrays directly
            mh._arr = np.unique(np.concatenate(parts))
        node_minhashes[h] = mh
        if store is not None:
            store[h] = (tuple(spans), mh)
    for nodes in path_minimizers:
        path_minimizers[nodes] = [node_minhashes[h] for h in nodes]
    return path_minimizers


def get_minimizers_from_minhashes(path_nodes, path_minimizers):
    s = set()
    for mh in path_minimizers[tuple(path_nodes)]:
        s.update(mh.hashes)
    return s


def _path_minimizer_array(nodes_key, path_minimizers, cache):
    """Distinct minimizer hashes of a path as a sorted uint64 array —
    the array twin of get_minimizers_from_minhashes. Cached per path:
    the pairwise containment pass re-derived the LOWER path's union for
    every higher partner (O(paths^2) set unions, the sweep's largest
    correction cost at 500k)."""
    arr = cache.get(nodes_key)
    if arr is None:
        parts = []
        for mh in path_minimizers[nodes_key]:
            a = mh._arr
            if a is None:
                h = mh.hashes
                a = np.fromiter(h, np.uint64, len(h))
                a.sort()
            parts.append(a)
        if parts:
            arr = np.unique(np.concatenate(parts))
        else:
            arr = np.empty(0, np.uint64)
        cache[nodes_key] = arr
    return arr


def _sorted_intersection_size(a, b):
    """|a ∩ b| for sorted distinct uint64 arrays (binary-search merge —
    np.intersect1d would re-sort the concatenation)."""
    if len(a) == 0 or len(b) == 0:
        return 0
    if len(a) > len(b):
        a, b = b, a
    idx = np.searchsorted(b, a)
    idx_c = np.minimum(idx, len(b) - 1)
    return int(np.count_nonzero(b[idx_c] == a))


# ----------------------------------------------------- correction operations


def define_correction_operations(
    graph,
    paths,
    path_coverages,
    correction_operations,
    path_minimizers,
    seen_nodes,
    threshold,
    minimizer_arrays=None,
):
    """Pairwise sketch-containment corrections within one terminal bin
    (construct_graph.py:2196-2265 semantics). Containment runs on sorted
    distinct hash ARRAYS with the per-path union cached across the whole
    sweep (`minimizer_arrays`) — the set-based pass re-unioned the lower
    path's node sketches once per higher partner."""
    corrected_paths = set()
    for p in paths:
        path_coverages.append(p[1])
    if minimizer_arrays is None:
        minimizer_arrays = {}
    for i in range(len(paths)):
        higher_path, higher_cov = paths[i]
        higher_nodes = [n[0] for n in higher_path]
        higher_set = set(higher_nodes)
        higher_tuple = tuple(higher_nodes)
        if higher_tuple in corrected_paths:
            continue
        if any(n in seen_nodes for n in higher_nodes):
            continue
        high_arr = (
            _path_minimizer_array(
                higher_tuple, path_minimizers, minimizer_arrays
            )
            if path_minimizers is not None
            else None
        )
        for lower_path, lower_cov in paths[i + 1 :]:
            lower_nodes = [n[0] for n in lower_path]
            lower_tuple = tuple(lower_nodes)
            if lower_tuple in corrected_paths:
                continue
            if any(n in seen_nodes for n in lower_nodes):
                continue
            if path_minimizers is None:
                # no sequence-similarity evidence -> no correction (the
                # reference cannot reach this state: its None path raises;
                # the pipeline always computes sketches)
                continue
            low_arr = _path_minimizer_array(
                lower_tuple, path_minimizers, minimizer_arrays
            )
            if len(low_arr) == 0 or len(high_arr) == 0:
                continue
            inter = _sorted_intersection_size(high_arr, low_arr)
            containment = max(
                inter / len(low_arr), inter / len(high_arr)
            )
            if containment > threshold:
                operation = (lower_tuple, higher_tuple, lower_cov, higher_cov)
                correction_operations.add(operation)
                corrected_paths.add(lower_tuple)
                for n in lower_nodes:
                    if n not in higher_set:
                        seen_nodes[n] = operation
    return path_coverages


def get_path_reads_to_correct(graph, reads_to_correct, seen_nodes):
    for n in seen_nodes:
        operation = seen_nodes[n]
        for read in graph.get_node_by_hash(n).reads:
            if read not in reads_to_correct:
                reads_to_correct[read] = operation


# ---------------------------------------------------------- gene alignment


def reverse_gene(gene):
    if gene[0] == "+":
        return "-" + gene[1:]
    if gene[0] == "-":
        return "+" + gene[1:]
    if gene[0] == "*":
        return "*"


def reverse_gene_alignment(alignment):
    return [
        (reverse_gene(col[0]), reverse_gene(col[1]))
        for col in reversed(alignment)
    ]


def count_snps_in_alignment(aln):
    return len(
        [c for c in aln if c[0] != c[1] and c[0] != "*" and c[1] != "*"]
    )


def count_indels_in_alignment(aln):
    return len(
        [c for c in aln if c[0] != c[1] and (c[0] == "*" or c[1] == "*")]
    )


def compare_paths(lower_genes, fw_higher_genes):
    fw = needleman_wunsch(fw_higher_genes, lower_genes)
    rv = reverse_gene_alignment(fw)
    return fw, rv, count_snps_in_alignment(fw), count_indels_in_alignment(fw)


def get_gene_mer_strings(genes_on_read, k):
    return [
        tuple(genes_on_read[i : i + k])
        for i in range(len(genes_on_read) - (k - 1))
    ]


def reorient_alignment(
    gene_mers_on_read, fw_counter, bw_counter, fw_alignment, rv_alignment
):
    read_counter = Counter(gene_mers_on_read)
    fw_count = len(read_counter & fw_counter)
    rv_count = len(read_counter & bw_counter)
    if fw_count > rv_count:
        return fw_alignment
    if rv_count > fw_count:
        return rv_alignment
    return None


def get_path_to_alignment_mapping(alignment):
    higher_mapping, lower_mapping = {}, {}
    hi = lo = 0
    for i, col in enumerate(alignment):
        if col[1] != "*":
            lower_mapping[lo] = i
            lo += 1
        if col[0] != "*":
            higher_mapping[hi] = i
            hi += 1
    return higher_mapping, lower_mapping


def longest_common_sublist(a, b):
    """Longest contiguous common sublist (construct_graph.py:1992-2014).
    Elements intern to small ints first — the object-array broadcast
    compared PyObjects pairwise and dominated the splice interiors."""
    len_a, len_b = len(a), len(b)
    if len_a == 0 or len_b == 0:
        return [], (0, -1), (0, -1)
    ids: dict = {}
    ai = np.fromiter(
        (ids.setdefault(x, len(ids)) for x in a), np.int32, len_a
    )
    bi = np.fromiter(
        (ids.setdefault(x, len(ids)) for x in b), np.int32, len_b
    )
    eq = ai[:, None] == bi[None, :]
    dp = np.zeros((len_a + 1, len_b + 1), dtype=np.int32)
    for i in range(1, len_a + 1):
        dp[i, 1:] = np.where(eq[i - 1], dp[i - 1, :-1] + 1, 0)
    max_len = int(dp.max())
    if max_len == 0:
        return [], (0, -1), (0, -1)
    flat = int(dp.argmax())
    end_a, end_b = divmod(flat, len_b + 1)
    start_a, start_b = end_a - max_len, end_b - max_len
    return a[start_a:end_a], (start_a, end_a - 1), (start_b, end_b - 1)


def modify_alignment_subset(alignment_subset, genes_on_read_segment):
    true_path = [c[0] for c in alignment_subset if c[0] != "*"]
    if true_path == genes_on_read_segment:
        return alignment_subset
    return needleman_wunsch(true_path, genes_on_read_segment)


def correct_genes_on_read(
    graph, genes_on_read, first_idx, last_idx, alignment_subset, read_id
):
    prefix = genes_on_read[:first_idx]
    suffix = genes_on_read[last_idx + 1 :]
    core = [c[0] for c in alignment_subset if c[0] != "*"]
    graph.get_reads()[read_id] = prefix + core + suffix
    return graph.get_reads()[read_id]


def correct_gene_positions_on_read(
    graph, first_idx, last_idx, alignment_subset, read_id, fastq_data
):
    gene_positions = graph.get_gene_positions()[read_id][:]
    prefix = gene_positions[:first_idx]
    suffix = gene_positions[last_idx + 1 :]
    core = gene_positions[first_idx : last_idx + 1]
    # remap the core through the alignment
    new_core = []
    ci = 0
    for col in alignment_subset:
        if col[0] != "*":
            if col[1] != col[0]:
                new_core.append((None, None))
            else:
                new_core.append(core[ci])
                ci += 1
        else:
            ci += 1
    new_positions = prefix + new_core + suffix
    new_positions = replace_invalid_gene_positions(new_positions, fastq_data, read_id)
    graph.get_gene_positions()[read_id] = new_positions
    assert len(graph.get_reads()[read_id]) == len(new_positions), (
        f"{len(graph.get_reads()[read_id])}/{len(new_positions)}"
    )
    return new_positions


# --------------------------------------------------------------- the driver


def correct_bubble_paths(
    graph,
    bubbles,
    fastq_data,
    path_minimizers,
    genesOfInterest,
    min_path_coverage,
    threshold=0.80,
):
    k = graph.get_kmerSize()
    seen_nodes: dict = {}
    correction_operations: set = set()
    reads_to_correct: dict = {}
    path_coverages: list = []
    minimizer_arrays: dict = {}  # per-path union cache, sweep-wide
    for pair in bubbles:
        if len(bubbles[pair]) > 1:
            paths = sorted(list(bubbles[pair]), key=lambda x: x[1], reverse=True)
            path_coverages = define_correction_operations(
                graph,
                paths,
                path_coverages,
                correction_operations,
                path_minimizers,
                seen_nodes,
                threshold,
                minimizer_arrays,
            )
    get_path_reads_to_correct(graph, reads_to_correct, seen_nodes)

    fw_alignments, bw_alignments = {}, {}
    fw_counters, bw_counters = {}, {}
    for operation in correction_operations:
        try:
            fw_higher_genes = graph.get_genes_in_unitig(list(operation[1]))
            lower_genes = graph.get_genes_in_unitig(list(operation[0]))
        except (ValueError, AssertionError, KeyError):
            continue
        fw_alignment, rv_alignment, _snps, _indels = compare_paths(
            lower_genes, fw_higher_genes
        )
        # never delete an AMR gene via a correction
        if any(
            c[1][1:] in genesOfInterest and c[0][1:] not in genesOfInterest
            for c in fw_alignment
        ):
            continue
        fw_alignments[operation] = fw_alignment
        bw_alignments[operation] = rv_alignment
        gene_mers = get_gene_mer_strings(lower_genes, k)
        rev_gene_mers = [
            tuple(graph.reverse_list_of_genes(list(gm))) for gm in gene_mers
        ]
        fw_counters[operation] = Counter(gene_mers)
        bw_counters[operation] = Counter(rev_gene_mers)

    # the reorient/LCS/NW chain is a pure function of (operation, the
    # read's gene sequence); after cleaning convergence most reads share
    # gene sequences, so compute each distinct pair ONCE and replay the
    # (first_idx, last_idx, alignment_subset) result per read — only the
    # per-read position bookkeeping runs in the read loop
    splice_cache: dict = {}
    _MISS = object()
    for read_id in reads_to_correct:
        op = reads_to_correct[read_id]
        if op not in fw_alignments:
            continue
        genes_on_read = graph.get_reads()[read_id][:]
        key = (op, tuple(genes_on_read))
        hit = splice_cache.get(key, _MISS)
        if hit is _MISS:
            hit = None
            gene_mers_on_read = get_gene_mer_strings(genes_on_read, k)
            read_alignment = reorient_alignment(
                gene_mers_on_read,
                fw_counters[op],
                bw_counters[op],
                fw_alignments[op],
                bw_alignments[op],
            )
            if read_alignment is not None:
                _hm, lower_mapping = get_path_to_alignment_mapping(
                    read_alignment
                )
                genes_in_lower = [
                    a[1] for a in read_alignment if a[1] != "*"
                ]
                common, (start_path, end_path), (first_idx, last_idx) = (
                    longest_common_sublist(genes_in_lower, genes_on_read)
                )
                held = bool(common)
                if held:
                    lo_col = lower_mapping[start_path]
                    hi_col = lower_mapping[end_path]
                    lo_open = first_idx == 0
                    hi_open = last_idx == len(genes_on_read) - 1
                    # the shared run ends at the read's end or where the
                    # read leaves the lower path; a read that goes on past
                    # the run may hold the higher path beyond it, and
                    # splicing the higher path over it writes a neighbour
                    # gene in the place of a correct call (the reference
                    # does; ROADMAP Queue 1). Both paths of a bubble can be
                    # wrong, each at its own column, so no differing column
                    # may lie at or past an end of the run where the read
                    # goes on.
                    held = not any(
                        (i <= lo_col and not lo_open)
                        or (i >= hi_col and not hi_open)
                        for i, col in enumerate(read_alignment)
                        if col[0] != col[1]
                    )
                if held:
                    alignment_subset = read_alignment[lo_col : hi_col + 1]
                    alignment_subset = modify_alignment_subset(
                        alignment_subset,
                        genes_on_read[first_idx : last_idx + 1],
                    )
                    if len(alignment_subset) != 0:
                        hit = (first_idx, last_idx, alignment_subset)
            splice_cache[key] = hit
        if hit is None:
            continue
        first_idx, last_idx, alignment_subset = hit
        correct_genes_on_read(
            graph, genes_on_read, first_idx, last_idx, alignment_subset,
            read_id,
        )
        correct_gene_positions_on_read(
            graph, first_idx, last_idx, alignment_subset, read_id,
            fastq_data,
        )
    return path_coverages


def correct_low_coverage_paths(
    graph,
    fastq_data,
    genesOfInterest,
    cores,
    min_path_coverage,
    components_to_skip,
    use_minimizers=False,
):
    """One bubble-popping sweep over every component
    (construct_graph.py:2196-2250)."""
    assert graph.get_gene_positions()
    potential_bubble_starts = identify_potential_bubble_starts(graph)
    max_distance = graph.get_kmerSize() * 4
    path_coverages: list = []
    for component in graph.components():
        if component in components_to_skip:
            continue
        if component not in potential_bubble_starts:
            continue
        starts = potential_bubble_starts[component]
        t0 = time.perf_counter()
        levels, hash_list = get_all_paths_between_junctions_in_component(
            graph, starts, max_distance, return_matrices=True
        )
        t1 = time.perf_counter()
        TIMER.count("path_search", t1 - t0)
        filtered = filter_path_matrices(graph, levels, hash_list)
        sorted_filtered = sorted(filtered, key=lambda x: len(x[0]))
        t2 = time.perf_counter()
        TIMER.count("path_filter", t2 - t1)
        if use_minimizers:
            path_minimizers = get_minhashes_for_paths(
                graph, sorted_filtered, fastq_data
            )
        else:
            path_minimizers = None
        t3 = time.perf_counter()
        TIMER.count("sketches", t3 - t2)
        binned = separate_paths_by_terminal_nodes(sorted_filtered)
        path_coverages += correct_bubble_paths(
            graph,
            binned,
            fastq_data,
            path_minimizers,
            genesOfInterest,
            min_path_coverage,
        )
        TIMER.count("corrections", time.perf_counter() - t3)
    return (
        graph.get_reads(),
        graph.get_gene_positions(),
        path_coverages,
        min_path_coverage,
    )
