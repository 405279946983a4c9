"""Data-parallel gene-mer graph build over a list of torch devices.

Port of the part of `amira_tpu/parallel/distgraph.py` that the pipeline's
distributed build (--dist-build) runs: `bounded_count_min`, the per-shard
step of `make_distributed_graph_step` on a one-axis ("data",) mesh, and
`distributed_graph_build`.

The mesh is a sequence of torch devices, one per shard; a device may
repeat, which is how one card (or the CPU) runs several shards. Reads are
split into contiguous row blocks, one per shard. Each shard windows its
reads on its device (`ops/hashing.genemer_windows`, `edge_key`) and reduces
its node occurrences and edge records to tables of (unique key, coverage,
first-occurrence order key). The JAX package's all_gather plus re-reduce
over the mesh becomes a copy of every shard's tables to the first device,
a concatenation and one more `bounded_count_min`. The host then builds the
graph from the merged tables and the shards' window streams
(`GeneMerGraph._finish_from_distributed_tables`), identical (node hashes,
coverages, read lists, edges, insertion order) to the JAX package's
distributed build of the same reads.

What XLA's static shapes forced stays behind: torch tables take their exact
size, so there are no fixed capacities and no retry ladder that doubles
them on overflow.

Hashes are int64 tensors holding uint64 bit patterns (see ops/hashing);
tables are ordered by key as UNSIGNED values, as the JAX package's uint64
sorts order them, so node hashes of 2^63 and above sort after the rest.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hashing import edge_key, genemer_windows

# x ^ _SIGN maps uint64 order onto int64 order (flips the sign bit)
_SIGN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def bounded_count_min(keys, weights, orderkeys):
    """Unique keys with their summed weights and their least order key.

    keys:      (N,) int64 holding uint64 bit patterns (0 = invalid, left out)
    weights:   (N,) integer
    orderkeys: (N,) int64 (a global first-occurrence order, below 2^63)
    Returns (table_keys, table_counts, table_first), (U,) int64 each, on the
    keys' device, table_keys ascending as unsigned 64-bit values. The JAX
    package's version returns the same rows in a fixed capacity, padded with
    key 0."""
    valid = keys != 0
    uk, inv = torch.unique(keys[valid] ^ _SIGN, sorted=True, return_inverse=True)
    counts = torch.zeros(uk.numel(), dtype=torch.int64, device=keys.device)
    counts.scatter_add_(0, inv, weights[valid].to(torch.int64))
    firsts = torch.full((uk.numel(),), _INT64_MAX, dtype=torch.int64, device=keys.device)
    firsts.scatter_reduce_(0, inv, orderkeys[valid].to(torch.int64), "amin")
    return uk ^ _SIGN, counts, firsts


def _shard_step(tokens, lengths, win_base, pair_base, k: int):
    """One shard's tables (the body of `make_distributed_graph_step`'s
    shard_step on a ("data",) mesh, before the merge).

    tokens (R, L) int32, lengths (R,), win_base / pair_base (R,) int64: each
    row's global offset in the valid-window stream and in the window-pair
    stream. Order keys: a node occurrence's global window position; an edge
    record's 2 * global pair position + slot (0 for the pair read forward,
    1 for its reverse-complement companion). Returns (node table, edge
    table, window hashes (R, W) with 0 past each read, directions (R, W)
    int8 with 0 past each read)."""
    dev = tokens.device
    win = genemer_windows(tokens, lengths, k)
    nh_raw, nd, valid = win["node_hash"], win["direction"], win["valid"]
    W = nh_raw.shape[1]
    nh = torch.where(valid, nh_raw, 0)
    occ_ok = win_base[:, None] + torch.arange(W, device=dev)[None, :]
    nodes = bounded_count_min(
        nh.reshape(-1), torch.ones(nh.numel(), dtype=torch.int32, device=dev),
        occ_ok.reshape(-1),
    )
    if W >= 2:
        src_h, tgt_h = nh_raw[:, :-1], nh_raw[:, 1:]
        src_d, tgt_d = nd[:, :-1], nd[:, 1:]
        ev = valid[:, :-1] & valid[:, 1:]
        e1 = torch.where(ev, edge_key(src_h, src_d, tgt_h, tgt_d), 0)
        e2 = torch.where(ev, edge_key(tgt_h, -tgt_d, src_h, -src_d), 0)
        pair_pos = pair_base[:, None] + torch.arange(W - 1, device=dev)[None, :]
        ek = torch.stack([e1, e2], dim=-1).reshape(-1)
        eok = torch.stack([pair_pos * 2, pair_pos * 2 + 1], dim=-1).reshape(-1)
    else:
        ek = torch.zeros(0, dtype=torch.int64, device=dev)
        eok = torch.zeros(0, dtype=torch.int64, device=dev)
    edges = bounded_count_min(
        ek, torch.ones(ek.numel(), dtype=torch.int32, device=dev), eok
    )
    return nodes, edges, nh, torch.where(valid, nd, 0).to(torch.int8)


def _merge(tables, device):
    """The shards' tables merged on `device`: the JAX package's all_gather
    over the "data" axis plus one more bounded_count_min."""
    keys, counts, firsts = (
        torch.cat([t[i].to(device) for t in tables]) for i in range(3)
    )
    return bounded_count_min(keys, counts, firsts)


def distributed_graph_build(
    read_dict, k: int, devices, vocab=None, gene_positions=None,
):
    """Build a GeneMerGraph with its reads split over `devices` (a sequence
    of torch devices or names, one shard each; repeats allowed) and the
    shards' node/edge tables merged on the first device. The result equals
    the JAX package's `distributed_graph_build` of the same reads over a
    ("data",) mesh: node hashes, coverages, read lists, edge endpoints and
    insertion order.

    As there, every read is tokenized (interning its genes in `vocab`)
    before reads shorter than k are set aside, so gene ids, and with them
    node hashes, follow that order; the cached single-device build skips
    short reads and can number genes otherwise."""
    from ..graph import GeneMerGraph
    from ..vocab import GeneVocab, pack_reads

    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("distributed_graph_build: no devices")
    if vocab is None:
        vocab = GeneVocab()
    graph = GeneMerGraph.__new__(GeneMerGraph)
    graph._reads = dict(read_dict)
    graph._kmerSize = int(k)
    graph._genePositions = gene_positions
    graph._minNodeCoverage = 1
    graph._minEdgeCoverage = 1
    graph.vocab = vocab
    graph._cache = None
    graph._nodes_d = {}
    graph._edges_d = {}
    graph._readNodes_d = {}
    graph._readNodeDirections_d = {}
    graph._readNodePositions_d = {}
    graph._shortReads = {}
    graph._readsToCorrect = set()
    graph._lazy = None

    kept_ids = []
    tok_list = []
    all_toks = vocab.encode_reads_batch(list(read_dict.values()))
    for (rid, genes), toks in zip(read_dict.items(), all_toks):
        if len(toks) < k:
            graph._shortReads[rid] = genes
            continue
        kept_ids.append(rid)
        tok_list.append(toks)
    if not kept_ids:
        return graph

    lens = np.fromiter((len(t) for t in tok_list), np.int64, len(tok_list))
    tokens, lengths = pack_reads(tok_list, pad_to=int(lens.max()))
    wlens = lens - (k - 1)
    offs = np.zeros(len(kept_ids) + 1, np.int64)
    np.cumsum(wlens, out=offs[1:])
    poffs = np.zeros(len(kept_ids) + 1, np.int64)
    np.cumsum(lens - k, out=poffs[1:])

    R = len(kept_ids)
    rows = -(-R // len(devices))  # the JAX package's rows per device
    node_tables, edge_tables, wh_parts, wd_parts = [], [], [], []
    for s, dev in enumerate(devices):
        lo, hi = s * rows, min((s + 1) * rows, R)
        if lo >= hi:
            continue
        nodes, edges, wh, wd = _shard_step(
            torch.from_numpy(tokens[lo:hi]).to(dev),
            torch.from_numpy(lengths[lo:hi]).to(dev),
            torch.from_numpy(offs[lo:hi]).to(dev),
            torch.from_numpy(poffs[lo:hi]).to(dev),
            k,
        )
        node_tables.append(nodes)
        edge_tables.append(edges)
        wh_parts.append(wh.cpu())
        wd_parts.append(wd.cpu())
    uh, counts, first_idx = (
        t.cpu().numpy() for t in _merge(node_tables, devices[0])
    )
    uek, e_counts, e_first = (
        t.cpu().numpy() for t in _merge(edge_tables, devices[0])
    )
    graph._finish_from_distributed_tables(
        kept_ids, tok_list, lens, offs,
        uh.view(np.uint64), counts, first_idx,
        uek.view(np.uint64), e_counts, e_first,
        torch.cat(wh_parts).numpy().view(np.uint64), torch.cat(wd_parts).numpy(),
    )
    return graph
