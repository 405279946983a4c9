"""Data-parallel gene-mer statistics and graph builds over a device mesh.

Port of `amira_tpu/parallel/distgraph.py`: the bounded count tables, the
count-only steps on the ("data",), ("data", "table") and ("host", "data",
"table") meshes with their host entries and `scaling_report`, the full
graph build on every mesh family, and the bin-sharded DNA k-mer table.

Reads shard data-parallel over every axis of the mesh (`parallel/mesh`):
shard s of n takes rows [s * R / n, (s + 1) * R / n). Each shard windows
its reads on its device (`ops/hashing.genemer_windows`, `edge_key`) and
reduces them to count tables. The JAX package's collectives become copies
between the shards' devices (`mesh.gather`): a hash-partitioned mesh
routes each table entry to the shard that owns its partition (the key, an
unsigned 64-bit value, mod T), the "data" axis's partial tables of a
partition merge on one device of that partition, and the "host" axis's
after them. A process group splits the first axis over processes, and
then the cross-host merge is `mesh.all_gather_processes`.

Two kinds of tables:

* The count-only steps keep the JAX package's capacities, because their
  results depend on them: `bounded_count` keeps the `capacity` smallest
  keys (unsigned order) and drops the rest with their counts, and the
  route keeps the first `max(N // T * 2, 128)` entries bound for each
  partition (N: the shard's windows) and drops the rest uncounted.
* The graph build's tables take their exact size (`bounded_count_min`):
  the JAX build retries with larger capacities until nothing is dropped,
  so its result is the exact one, which the port computes at once. Its
  route is sized to the largest bucket and never drops.

Hashes are int64 tensors holding uint64 bit patterns (see ops/hashing);
tables are ordered by key as UNSIGNED values, as the JAX package's uint64
sorts order them, so keys of 2^63 and above sort after the rest.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops.hashing import edge_key, genemer_windows
from .mesh import (
    Mesh, all_gather_processes, as_mesh, gather, psum_processes, reduce_scatter_processes,
)

# x ^ _SIGN maps uint64 order onto int64 order (flips the sign bit)
_SIGN = -(1 << 63)
_INT64_MAX = (1 << 63) - 1


def _unsigned_mod(keys, T: int):
    """keys (int64 holding uint64 bit patterns) mod T as unsigned values."""
    if T & (T - 1) == 0:
        return keys & (T - 1)
    half = (keys >> 1) & _INT64_MAX  # logical shift: the value // 2
    return ((half % T) * 2 + (keys & 1)) % T


def _unique_unsigned(keys):
    """Nonzero keys' unique values in ascending unsigned order, and the
    index of each nonzero key among them (with the nonzero mask)."""
    valid = keys != 0
    uk, inv = torch.unique(keys[valid] ^ _SIGN, sorted=True, return_inverse=True)
    return uk ^ _SIGN, inv, valid


def bounded_count(keys, weights, capacity: int):
    """Sorted unique keys with their summed weights, in a fixed capacity.

    keys: (N,) int64 holding uint64 bit patterns (0 = invalid, left out);
    weights: (N,) integer. Returns (table_keys int64, table_counts int32),
    (capacity,) each: the `capacity` smallest keys in ascending unsigned
    order with their sums; unused slots hold key 0 and count 0, and keys
    past the capacity are dropped with their counts."""
    uk, inv, valid = _unique_unsigned(keys)
    sums = torch.zeros(uk.numel(), dtype=torch.int64, device=keys.device)
    sums.scatter_add_(0, inv, weights[valid].to(torch.int64))
    n = min(uk.numel(), capacity)
    table_keys = torch.zeros(capacity, dtype=torch.int64, device=keys.device)
    table_counts = torch.zeros(capacity, dtype=torch.int32, device=keys.device)
    table_keys[:n] = uk[:n]
    table_counts[:n] = sums[:n].to(torch.int32)
    return table_keys, table_counts


def bounded_count_min(keys, weights, orderkeys):
    """Unique keys with their summed weights and their least order key.

    keys:      (N,) int64 holding uint64 bit patterns (0 = invalid, left out)
    weights:   (N,) integer
    orderkeys: (N,) int64 (a global first-occurrence order, below 2^63)
    Returns (table_keys, table_counts, table_first), (U,) int64 each, on the
    keys' device, table_keys ascending as unsigned 64-bit values. The JAX
    package's version returns the same rows in a fixed capacity, padded with
    key 0."""
    uk, inv, valid = _unique_unsigned(keys)
    counts = torch.zeros(uk.numel(), dtype=torch.int64, device=keys.device)
    counts.scatter_add_(0, inv, weights[valid].to(torch.int64))
    firsts = torch.full((uk.numel(),), _INT64_MAX, dtype=torch.int64, device=keys.device)
    firsts.scatter_reduce_(0, inv, orderkeys[valid].to(torch.int64), "amin")
    return uk, counts, firsts


def _ones(n: int, device):
    return torch.ones(n, dtype=torch.int32, device=device)


def _edge_records(nh_raw, nd, valid):
    """Both edge keys of every adjacent window pair: the pair read forward
    and its reverse-complement companion, each (R, W - 1), 0 where either
    window is invalid."""
    src_h, tgt_h = nh_raw[:, :-1], nh_raw[:, 1:]
    src_d, tgt_d = nd[:, :-1], nd[:, 1:]
    ev = valid[:, :-1] & valid[:, 1:]
    e1 = torch.where(ev, edge_key(src_h, src_d, tgt_h, tgt_d), 0)
    e2 = torch.where(ev, edge_key(tgt_h, -tgt_d, src_h, -src_d), 0)
    return e1, e2


def local_genemer_tables(tokens, lengths, k: int, capacity: int):
    """Node and edge count tables of a padded read batch, on its device:
    (node_keys, node_counts, edge_keys, edge_counts), (capacity,) each."""
    tokens = torch.as_tensor(tokens)
    dev = tokens.device
    win = genemer_windows(tokens, lengths, k)
    nh = torch.where(win["valid"], win["node_hash"], 0)
    node_keys, node_counts = bounded_count(nh.reshape(-1), _ones(nh.numel(), dev), capacity)
    if nh.shape[1] >= 2:
        e1, e2 = _edge_records(win["node_hash"], win["direction"], win["valid"])
        ekeys = torch.cat([e1.reshape(-1), e2.reshape(-1)])
    else:
        ekeys = torch.zeros(2, dtype=torch.int64, device=dev)
    edge_keys, edge_counts = bounded_count(ekeys, _ones(ekeys.numel(), dev), capacity)
    return node_keys, node_counts, edge_keys, edge_counts


# ------------------------------------------------------ count-only steps


def _shard_rows(mesh, *arrays):
    """(global shard index, device, blocks) for each of this process's
    shards: its contiguous block of rows of every array, on its device. The
    row count must be a multiple of the mesh size (the host entries pad)."""
    R = arrays[0].shape[0]
    if R % mesh.size:
        raise ValueError(f"{R} rows do not split over {mesh.size} shards")
    rows = R // mesh.size
    for flat, dev in mesh.local_shards():
        yield flat, dev, [
            torch.as_tensor(a[flat * rows : (flat + 1) * rows]).to(dev) for a in arrays
        ]


def _valid_hashes(tokens, lengths, k: int):
    win = genemer_windows(tokens, lengths, k)
    return torch.where(win["valid"], win["node_hash"], 0).reshape(-1), win["valid"]


def _route_table(keys, counts, firsts, T: int, send_cap: int):
    """Route table entries to their hash-partition owner (key % T, unsigned)
    for an all_to_all over the "table" axis. Each destination keeps its
    first send_cap entries in input order. Returns the (T, send_cap) send
    buffers of keys, counts and firsts (None where None was given), padded
    with zeros, and the number of entries dropped by the capacity."""
    dev = keys.device
    dest = torch.where(keys == 0, T, _unsigned_mod(keys, T))
    order = torch.argsort(dest, stable=True)
    sd = dest[order]
    first_of_dest = torch.searchsorted(sd, torch.arange(T + 1, device=dev))
    idx = torch.arange(sd.numel(), device=dev) - first_of_dest[sd.clamp(0, T)]
    ok = (sd < T) & (idx < send_cap)
    dropped = int(((sd < T) & ~ok).sum())
    row = torch.where(ok, sd, 0)
    col = torch.where(ok, idx, send_cap)

    def send(values):
        if values is None:
            return None
        buf = torch.zeros((T, send_cap + 1), dtype=values.dtype, device=dev)
        buf[row, col] = torch.where(ok, values[order], 0)
        return buf[:, :send_cap]

    return send(keys), send(counts), send(firsts), dropped


def _hdt(mesh):
    """(host, data, table) extents of a mesh, 1 for an axis it lacks."""
    return mesh.axis("host"), mesh.axis("data"), mesh.axis("table")


def _flat(mesh, h: int, d: int, t: int) -> int:
    _, D, T = _hdt(mesh)
    return (h * D + d) * T + t


def _local_hosts(mesh):
    """Global "host" indices whose shards live in this process."""
    if mesh.group is not None and mesh.axis_names[0] != "host":
        raise ValueError("a table-sharded mesh over processes splits its 'host' axis")
    H_local = mesh.devices.shape[0] if "host" in mesh.axis_names else 1
    return range(mesh.rank * H_local, (mesh.rank + 1) * H_local)


def make_distributed_genemer_step(mesh, k: int, capacity: int):
    """Count step on a ("data",) mesh: each shard's bounded node table, all
    gathered in mesh order and counted again. step(tokens, lengths) takes
    the whole (R, L) batch (host arrays) and returns (keys, counts) of
    `capacity` on the mesh's first device and the total of valid windows."""
    mesh = as_mesh(mesh)

    def step(tokens, lengths):
        dev0 = mesh.first_device
        keys, counts, total = [], [], 0
        for _, dev, (tok, ln) in _shard_rows(mesh, tokens, lengths):
            nh, valid = _valid_hashes(tok, ln, k)
            lk, lc = bounded_count(nh, _ones(nh.numel(), dev), capacity)
            keys.append(lk)
            counts.append(lc)
            total += int(valid.sum())
        all_keys = torch.cat(all_gather_processes(mesh, gather(keys, dev0)))
        all_counts = torch.cat(all_gather_processes(mesh, gather(counts, dev0)))
        merged_keys, merged_counts = bounded_count(all_keys, all_counts, capacity)
        return merged_keys, merged_counts, psum_processes(mesh, total)

    return step


def _table_count_step(mesh, k: int, capacity: int):
    """The count step of the ("data", "table") and ("host", "data",
    "table") meshes (the JAX package's _2d and _3d steps): each shard
    routes its hashes to their partition's owner in its (host, data) row,
    the owner counts them, the "data" axis's tables of each partition merge
    inside each host, then the hosts' tables merge. Returns (T, capacity)
    keys and counts, row t holding partition t, and the total of the
    owners' counts."""
    _, D, T = _hdt(mesh)
    has_host = "host" in mesh.axis_names

    def step(tokens, lengths):
        sends = {}
        for flat, dev, (tok, ln) in _shard_rows(mesh, tokens, lengths):
            nh, _ = _valid_hashes(tok, ln, k)
            sends[flat] = _route_table(nh, None, None, T, max(nh.numel() // T * 2, 128))[0]
        local, total = {}, 0
        for flat, dev in mesh.local_shards():
            row, t = flat - flat % T, flat % T
            mine = gather([sends[row + j][t] for j in range(T)], dev)
            local[flat] = bounded_count(mine, _ones(mine.numel(), dev), capacity)
            total += int(local[flat][1].sum())
        dev0 = mesh.first_device
        host_keys, host_counts = [], []
        for h in _local_hosts(mesh):
            per_t = []
            for t in range(T):
                flats = [_flat(mesh, h, d, t) for d in range(D)]
                dev = mesh.device_of(flats[0])
                per_t.append(bounded_count(
                    gather([local[f][0] for f in flats], dev),
                    gather([local[f][1] for f in flats], dev), capacity,
                ))
            host_keys.append(torch.stack([p[0].to(dev0) for p in per_t]))
            host_counts.append(torch.stack([p[1].to(dev0) for p in per_t]))
        # (H, T, capacity): every host's partition tables, in host order
        keys = torch.cat(all_gather_processes(mesh, torch.stack(host_keys)))
        counts = torch.cat(all_gather_processes(mesh, torch.stack(host_counts)))
        if has_host:
            merged = [
                bounded_count(keys[:, t].reshape(-1), counts[:, t].reshape(-1), capacity)
                for t in range(T)
            ]
            keys = torch.stack([m[0] for m in merged])
            counts = torch.stack([m[1] for m in merged])
        else:
            keys, counts = keys[0], counts[0]
        return keys, counts, psum_processes(mesh, total)

    return step


def make_distributed_genemer_step_2d(mesh, k: int, capacity: int):
    """Count step on a ("data", "table") mesh; see _table_count_step."""
    return _table_count_step(mesh, k, capacity)


def make_distributed_genemer_step_3d(mesh, k: int, capacity: int):
    """Hierarchical count step on a ("host", "data", "table") mesh: as the
    2D step inside each host, then the hosts' deduplicated partition tables
    merge (across processes when the mesh has a process group)."""
    return _table_count_step(mesh, k, capacity)


def _pad_rows(read_tokens, lengths, n: int):
    pad = (-read_tokens.shape[0]) % n
    if pad:
        read_tokens = np.vstack(
            [read_tokens, np.zeros((pad, read_tokens.shape[1]), read_tokens.dtype)]
        )
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
    return read_tokens, lengths


def _host_u64(t) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def distributed_node_counts(read_tokens, lengths, k: int, mesh, capacity: int = 1 << 16):
    """Host entry of the ("data",) count step: (keys uint64, counts int32),
    (capacity,) each with zeros past the table, and the total."""
    mesh = as_mesh(mesh)
    tokens, lengths = _pad_rows(np.asarray(read_tokens), np.asarray(lengths), mesh.size)
    keys, counts, total = make_distributed_genemer_step(mesh, k, capacity)(tokens, lengths)
    return _host_u64(keys), counts.cpu().numpy(), total


def _nonzero_partitions(keys, counts, total):
    keys, counts = _host_u64(keys).reshape(-1), counts.cpu().numpy().reshape(-1)
    mask = keys != 0
    return keys[mask], counts[mask], total


def distributed_node_counts_2d(read_tokens, lengths, k: int, mesh, capacity: int = 1 << 16):
    """Host entry of the 2D step: the partitions' tables concatenated in
    partition order, zeros left out, and the total."""
    tokens, lengths = _pad_rows(np.asarray(read_tokens), np.asarray(lengths), mesh.size)
    return _nonzero_partitions(*make_distributed_genemer_step_2d(mesh, k, capacity)(tokens, lengths))


def distributed_node_counts_3d(read_tokens, lengths, k: int, mesh, capacity: int = 1 << 16):
    """Host entry of the ("host", "data", "table") step, as the 2D one."""
    tokens, lengths = _pad_rows(np.asarray(read_tokens), np.asarray(lengths), mesh.size)
    return _nonzero_partitions(*make_distributed_genemer_step_3d(mesh, k, capacity)(tokens, lengths))


def scaling_report(read_tokens, lengths, k: int = 3, capacity: int = 1 << 14, repeats: int = 3,
                   devices=None):
    """Weak-scaling efficiency of the count steps over 1, 2, 4, ... of
    `devices` (default: the visible CUDA devices; a device may repeat): the
    ("data",) mesh from 1 device, (n/2, 2) ("data", "table") from 4 and
    (2, n/4, 2) ("host", "data", "table") from 8, each shard given a copy
    of the reads. Returns [{mesh, n_devices, reads_per_sec, efficiency}],
    efficiency = throughput / (n * the 1-device throughput); each timed
    call ends with its tables copied to the host."""
    if devices is None:
        from .. import visible_devices

        devices = visible_devices("cuda")
    devices = [torch.device(d) for d in devices]
    rows = []

    def timed(fn, n):
        tok, lens = np.tile(read_tokens, (n, 1)), np.tile(lengths, n)
        fn(tok, lens)  # warm
        best = None
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(tok, lens)
            dt = time.perf_counter() - t0
            best = dt if best is None else min(best, dt)
        return tok.shape[0] / best

    def grid(n, shape):
        return np.array(devices[:n], dtype=object).reshape(shape)

    base = None
    families = (
        (1, lambda n: f"{n} (data)", lambda n: Mesh(grid(n, (n,)), ("data",)),
         distributed_node_counts),
        (4, lambda n: f"{n // 2}x2 (data x table)",
         lambda n: Mesh(grid(n, (n // 2, 2)), ("data", "table")), distributed_node_counts_2d),
        (8, lambda n: f"2x{n // 4}x2 (host x data x table)",
         lambda n: Mesh(grid(n, (2, n // 4, 2)), ("host", "data", "table")),
         distributed_node_counts_3d),
    )
    for start, label, make_mesh, entry in families:
        n = start
        while n <= len(devices):
            mesh = make_mesh(n)
            rps = timed(lambda t, ln: entry(t, ln, k, mesh, capacity), n)
            if base is None:
                base = rps
            rows.append({
                "mesh": label(n),
                "n_devices": n,
                "reads_per_sec": round(rps, 1),
                "efficiency": round(rps / (n * base), 3),
            })
            n *= 2
    return rows


# --------------------------------------------------------- full graph build


def _shard_step(tokens, lengths, win_base, pair_base, k: int):
    """One shard's tables (the body of `make_distributed_graph_step`'s
    shard_step, before the merge).

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
    nodes = bounded_count_min(nh.reshape(-1), _ones(nh.numel(), dev), occ_ok.reshape(-1))
    if W >= 2:
        e1, e2 = _edge_records(nh_raw, nd, valid)
        pair_pos = pair_base[:, None] + torch.arange(W - 1, device=dev)[None, :]
        ek = torch.stack([e1, e2], dim=-1).reshape(-1)
        eok = torch.stack([pair_pos * 2, pair_pos * 2 + 1], dim=-1).reshape(-1)
    else:
        ek = torch.zeros(0, dtype=torch.int64, device=dev)
        eok = torch.zeros(0, dtype=torch.int64, device=dev)
    edges = bounded_count_min(ek, _ones(ek.numel(), dev), eok)
    return nodes, edges, nh, torch.where(valid, nd, 0).to(torch.int8)


def _merge_tables(mesh, tables):
    """The shards' exact tables ({global shard index: (keys, counts,
    firsts)}) merged as `make_distributed_graph_step`'s merge_tables does:
    routed to their partition's owner (on a mesh with a "table" axis), the
    "data" axis's tables of each partition merged inside each host, then
    the hosts'. Returns one table per partition, in partition order."""
    H, D, T = _hdt(mesh)
    if "table" in mesh.axis_names:
        # the route's capacity is the largest bucket, so nothing is dropped
        cap = max(
            [int(torch.bincount(_unsigned_mod(t[0], T), minlength=T).max())
             for t in tables.values() if t[0].numel()] + [1]
        )
        routed = {f: _route_table(*tables[f], T, cap) for f in tables}
        if any(r[3] for r in routed.values()):
            raise RuntimeError("distributed graph build: the exact route dropped entries")
        tables = {
            flat: bounded_count_min(*(
                gather([routed[flat - flat % T + j][i][flat % T] for j in range(T)], dev)
                for i in range(3)
            ))
            for flat, dev in mesh.local_shards()
        }
    parts = []
    for t in range(T):
        per_host = []
        for h in range(H):
            flats = [_flat(mesh, h, d, t) for d in range(D)]
            dev = mesh.device_of(flats[0])
            per_host.append(bounded_count_min(
                *(gather([tables[f][i] for f in flats], dev) for i in range(3))
            ))
        if "host" in mesh.axis_names:
            dev = mesh.device_of(_flat(mesh, 0, 0, t))
            per_host = [bounded_count_min(*(gather([p[i] for p in per_host], dev) for i in range(3)))]
        parts.append(per_host[0])
    return parts


def _merge_partitions(parts):
    """Host: the partitions' tables (disjoint by key % T) as one table in
    ascending unsigned key order, as numpy (keys uint64, counts, firsts)."""
    keys, counts, firsts = (torch.cat([p[i].cpu() for p in parts]) for i in range(3))
    order = torch.argsort(keys ^ _SIGN)
    return keys[order].numpy().view(np.uint64), counts[order].numpy(), firsts[order].numpy()


def distributed_graph_build(read_dict, k: int, mesh, vocab=None, gene_positions=None):
    """Build a GeneMerGraph with its reads sharded over every axis of
    `mesh` (a Mesh of one process: ("data",), ("data", "table") or ("host",
    "data", "table"); or a sequence of torch devices or names, meaning the
    ("data",) mesh; repeats allowed) and the shards' node/edge tables
    merged across it. The result equals the JAX package's
    `distributed_graph_build` of the same reads on a mesh of the same
    shape: node hashes, coverages, read lists, edge endpoints and insertion
    order.

    As there, every read is tokenized (interning its genes in `vocab`)
    before reads shorter than k are set aside, so gene ids, and with them
    node hashes, follow read order as in the uncached single-device build."""
    from ..graph import GeneMerGraph
    from ..vocab import GeneVocab, pack_reads

    mesh = as_mesh(mesh)
    if mesh.group is not None:
        raise ValueError("distributed_graph_build runs on a mesh of one process")
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
    rows = -(-R // mesh.size)  # the JAX package's rows per device
    node_tables, edge_tables, wh_parts, wd_parts = {}, {}, [], []
    empty = lambda dev: (torch.zeros(0, dtype=torch.int64, device=dev),) * 3  # noqa: E731
    for s, dev in mesh.local_shards():
        lo, hi = s * rows, min((s + 1) * rows, R)
        if lo >= hi:
            node_tables[s] = edge_tables[s] = empty(dev)
            continue
        node_tables[s], edge_tables[s], wh, wd = _shard_step(
            torch.from_numpy(tokens[lo:hi]).to(dev),
            torch.from_numpy(lengths[lo:hi]).to(dev),
            torch.from_numpy(offs[lo:hi]).to(dev),
            torch.from_numpy(poffs[lo:hi]).to(dev),
            k,
        )
        wh_parts.append(wh.cpu())
        wd_parts.append(wd.cpu())
    uh, counts, first_idx = _merge_partitions(_merge_tables(mesh, node_tables))
    uek, e_counts, e_first = _merge_partitions(_merge_tables(mesh, edge_tables))
    graph._finish_from_distributed_tables(
        kept_ids, tok_list, lens, offs,
        uh, counts, first_idx, uek, e_counts, e_first,
        torch.cat(wh_parts).numpy().view(np.uint64), torch.cat(wd_parts).numpy(),
    )
    return graph


# ---------------------------------------------------- distributed DNA k-mers


def kmer_layout(k: int, n_shards: int):
    """(Tp, B): the table's 4^k + 1 bins rounded up to a multiple of the
    shard count, and the bins each shard keeps (shard d: [d * B, (d + 1) *
    B)), as psum_scatter(tiled=True) leaves them."""
    T = 4**k + 1
    Tp = -(-T // n_shards) * n_shards
    return Tp, Tp // n_shards


def kmer_rows(codes, k: int, n_shards: int):
    """The code stream split into one chunk per shard at the JAX package's
    points (`distributed_kmer_count`: back to the last separator before
    each even cut; a cut inside a sequence longer than the span overlaps
    the next chunk by k - 1 codes), each padded with separators to a common
    length and packed. Returns (words (D, chunk/16) uint32, bad (D,
    chunk/8) uint8, chunk)."""
    from ..ops.kmer import _SENTINEL, _pack_codes_2bit

    D, n = n_shards, len(codes)
    starts, ends = [0], []
    for d in range(1, D):
        cut = max(min(n, (n * d) // D), starts[-1])
        next_start = cut
        if 0 < cut < n:
            seps = np.nonzero(codes[starts[-1] : cut] == _SENTINEL)[0]
            if len(seps):
                cut = starts[-1] + int(seps[-1]) + 1
                next_start = cut
            elif codes[cut - 1] != _SENTINEL:
                next_start = max(cut - (k - 1), starts[-1])
        ends.append(cut)
        starts.append(next_start)
    ends.append(n)
    chunks = [codes[starts[d] : ends[d]] for d in range(D)]
    chunk = max(max((len(c) for c in chunks), default=1), k)
    chunk = ((chunk + 15) // 16 * 16) + 16
    packed = [
        _pack_codes_2bit(np.concatenate([c, np.full(chunk - len(c), _SENTINEL, np.uint8)]))
        for c in chunks
    ]
    return np.stack([p[0] for p in packed]), np.stack([p[1] for p in packed]), chunk


def _count_shard(table, words, bad, k: int, chunk: int):
    """Add every window of one shard's packed codes (window starts 0 ..
    chunk - k) to `table`, streamed in pieces of at most _DENSE_CHUNK codes
    that overlap by the k - 1 codes of the windows across their seam."""
    from ..ops.kmer import _DENSE_CHUNK, _canonical_window_codes

    n_win, piece_words = chunk - k + 1, _DENSE_CHUNK // 16
    start = 0  # first window start not yet counted
    while start < n_win:
        w0 = start // 16
        w1 = min(w0 + piece_words, words.shape[0])
        end = min(16 * w1 - k + 1, n_win)
        idx = _canonical_window_codes(words[w0:w1], bad[2 * w0 : 2 * w1], k)
        idx = idx[start - 16 * w0 : end - 16 * w0]
        table.index_add_(0, idx, _ones(idx.numel(), table.device))
        start = end


def make_distributed_kmer_step(mesh, k: int, chunk: int):
    """Dense canonical k-mer count step over a ("kdata",) mesh (or a device
    list). step(words, bad) takes every shard's packed row (`kmer_rows`);
    each shard counts its row into a local (Tp,) int32 table on its device,
    and the tables are reduce-scattered: the step returns this process's
    shards' bin slices (kmer_layout), each on its shard's device. Each
    local table is freed once it has been summed."""
    from ..ops.kmer import _to_device_words

    if not isinstance(mesh, Mesh):
        mesh = Mesh(list(mesh), ("kdata",))
    Tp, B = kmer_layout(k, mesh.size)
    shards = mesh.local_shards()
    mine = slice(mesh.offset * B, (mesh.offset + mesh.local_size) * B)

    def step(words, bad):
        out = {g: torch.zeros(B, dtype=torch.int32, device=dev) for g, dev in shards}
        # bins bound for other processes, summed over this process's shards
        partial = (
            torch.zeros(Tp, dtype=torch.int32, device=mesh.first_device)
            if mesh.group is not None else None
        )
        for g, dev in shards:
            w, b = _to_device_words(words[g], bad[g], dev)
            local = torch.zeros(Tp, dtype=torch.int32, device=dev)
            _count_shard(local, w, b, k, chunk)
            for h, hdev in shards:
                out[h] += local[h * B : (h + 1) * B].to(hdev)
            if partial is not None:
                local[mine] = 0
                partial += local.to(partial.device)
            del local
        if partial is not None:
            summed = reduce_scatter_processes(mesh, partial)
            del partial
            for i, (g, dev) in enumerate(shards):
                out[g] += summed[i * B : (i + 1) * B].to(dev)
        return [out[g] for g, _ in shards]

    return step


def distributed_kmer_count(codes, k: int, devices=None):
    """Canonical k-mer counts of a sentinel-separated code stream over
    `devices` (a ("kdata",) Mesh of one process or a device list; default:
    the visible CUDA devices; repeats allowed): the dense table of 4^k + 1
    bins on the host as uint32 (the padded tail bins dropped; bin 4^k holds
    the invalid windows, padding included, as the JAX package counts them).
    Callers that keep the bin-sharded table use make_distributed_kmer_step."""
    if devices is None:
        from .. import visible_devices

        devices = visible_devices("cuda")
    mesh = devices if isinstance(devices, Mesh) else Mesh(list(devices), ("kdata",))
    if mesh.group is not None:
        raise ValueError("distributed_kmer_count gathers a mesh of one process")
    words, bad, chunk = kmer_rows(codes, k, mesh.size)
    shards = make_distributed_kmer_step(mesh, k, chunk)(words, bad)
    return torch.cat([s.cpu() for s in shards]).numpy().view(np.uint32)[: 4**k + 1]
