"""Entry points of the port's compute check and multi-device dry run: the
twin of the repository's `__graft_entry__.py` (the JAX package's)."""

from __future__ import annotations

import numpy as np
import torch


def entry(device=None):
    """(fn, example_args): the gene-mer windowing, canonicalization and
    count-table step that every graph build runs
    (`parallel/distgraph.local_genemer_tables`), and its example batch on
    `device` (default: the card; raises without CUDA)."""
    from . import resolve_device
    from .parallel.distgraph import local_genemer_tables

    dev = resolve_device("cuda" if device is None else device)
    k, capacity = 5, 1 << 12

    def fn(tokens, lengths):
        return local_genemer_tables(tokens, lengths, k, capacity)

    rng = np.random.RandomState(0)
    tokens = rng.randint(1, 100, size=(64, 32)).astype(np.int32)
    signs = rng.choice([-1, 1], size=tokens.shape).astype(np.int32)
    tokens = tokens * signs
    lengths = rng.randint(k, 33, size=(64,)).astype(np.int32)
    return fn, (torch.from_numpy(tokens).to(dev), torch.from_numpy(lengths).to(dev))


def mesh_devices(n_devices: int, device=None):
    """n_devices shards: the first n visible cards for device=None (raises
    without CUDA) when there are that many, else n shards of the first;
    n shards of `device` when one is named."""
    from . import resolve_device, visible_devices

    if device is None:
        cards = visible_devices("cuda")
        return cards[:n_devices] if len(cards) >= n_devices else [cards[0]] * n_devices
    return [resolve_device(device)] * n_devices


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The JAX twin's three checks on an n-shard mesh of the same family and
    shapes (`mesh_devices`): the count step on the ("host", "data",
    "table") mesh for n >= 8 divisible by 4, ("data", "table") for even
    n >= 4, else ("data",), its total equal to the valid windows; the full
    distributed graph build on that mesh equal to the single-device graph;
    the distributed k-mer table equal to the host counter. Raises on a
    mismatch; prints one line and returns its numbers."""
    from .graph import GeneMerGraph
    from .ops import kmer as K
    from .parallel.distgraph import (
        distributed_graph_build, distributed_kmer_count, distributed_node_counts,
        distributed_node_counts_2d, distributed_node_counts_3d,
    )
    from .parallel.mesh import Mesh
    from .vocab import GeneVocab

    devices = np.array(mesh_devices(n_devices, device), dtype=object)
    rng = np.random.RandomState(0)
    R, L, k = 8 * n_devices, 16, 3
    tokens = (
        rng.randint(1, 40, size=(R, L)).astype(np.int32)
        * rng.choice([-1, 1], size=(R, L)).astype(np.int32)
    )
    lengths = rng.randint(k, L + 1, size=(R,)).astype(np.int32)
    expected = int((np.maximum(lengths - (k - 1), 0)).sum())
    if n_devices >= 8 and n_devices % 4 == 0:
        mesh = Mesh(devices.reshape(2, n_devices // 4, 2), ("host", "data", "table"))
        keys, counts, total = distributed_node_counts_3d(tokens, lengths, k, mesh, capacity=1 << 10)
        shape = f"2x{n_devices // 4}x2 (host x data x table)"
    elif n_devices >= 4 and n_devices % 2 == 0:
        mesh = Mesh(devices.reshape(n_devices // 2, 2), ("data", "table"))
        keys, counts, total = distributed_node_counts_2d(tokens, lengths, k, mesh, capacity=1 << 10)
        shape = f"{n_devices // 2}x2 (data x table)"
    else:
        mesh = Mesh(devices, ("data",))
        keys, counts, total = distributed_node_counts(tokens, lengths, k, mesh, capacity=1 << 10)
        shape = f"{n_devices} (data)"
    if total != expected:
        raise AssertionError(f"count step total {total} != {expected} valid windows")
    n_unique = int((keys != 0).sum())
    if n_unique == 0:
        raise AssertionError("count step found no gene-mers")

    reads = {
        f"r{i}": [
            ("+" if rng.rand() < 0.5 else "-") + f"g{rng.randint(1, 30)}"
            for _ in range(rng.randint(k, 12))
        ]
        for i in range(6 * n_devices)
    }
    vocab = GeneVocab()
    g1 = GeneMerGraph(dict(reads), k, vocab=vocab, device=devices.reshape(-1)[0])
    g2 = distributed_graph_build(dict(reads), k, mesh, vocab=vocab)
    n1, n2 = g1.get_nodes(), g2.get_nodes()
    same = (
        list(n1) == list(n2)
        and all(
            (a.coverage, a.reads, a.fwd_edges, a.bwd_edges)
            == (n2[h].coverage, n2[h].reads, n2[h].fwd_edges, n2[h].bwd_edges)
            for h, a in n1.items()
        )
        and list(g1.get_edges()) == list(g2.get_edges())
        and g1.get_readNodes() == g2.get_readNodes()
    )
    if not same:
        raise AssertionError(f"distributed graph on the {shape} mesh != single-device graph")

    bases = np.array(list("ACGT"))
    seqs = [
        "".join(rng.choice(bases, size=int(rng.randint(40, 300))))
        for _ in range(6 * n_devices)
    ]
    kk = 7
    table = distributed_kmer_count(K._concat_codes(seqs), kk, list(devices.reshape(-1)))
    hostc = K.KmerCounter.from_sequences(seqs, kk, device="cpu")
    kmers = np.nonzero(table[:-1])[0]
    if not (np.array_equal(kmers.astype(np.uint32), hostc.kmers)
            and np.array_equal(table[kmers], hostc.counts.astype(np.uint32))):
        raise AssertionError("distributed k-mer table != host counter")
    print(
        f"dryrun_multichip OK: mesh {shape} on {devices.reshape(-1)[0]}, {total} gene-mer "
        f"occurrences, {n_unique} unique nodes; full distributed graph on the {shape} mesh == "
        f"single-device graph ({len(g1.get_nodes())} nodes, {len(g1.get_edges())} edges); "
        f"distributed k-mer table ({len(kmers)} distinct {kk}-mers over {n_devices} shards) == "
        f"host counter"
    )
    return {"mesh": shape, "total": total, "unique_nodes": n_unique,
            "nodes": len(g1.get_nodes()), "edges": len(g1.get_edges()), "kmers": len(kmers)}
