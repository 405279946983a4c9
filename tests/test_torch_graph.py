"""The port's gene-mer graph (`amira_tpu_torch.graph`) is identical to the
JAX package's: same node and edge dict orders, coverages, canonical tokens,
read lists, edge records, components and per-read tables (the field list of
tests/test_graph_cache.py), for cold builds and for mutated rebuilds through
a shared build cache, at k = 3, 5 and 7. One case forces every cache miss
through the port's torch `pack_flat_windows` instead of the NumPy mirror.

A cold build is held to both JAX builds as a caller makes them, with
fresh vocabularies: through a cache against JAX's cached build, and without
one (the port's `_build`, eager, its tables grouped on the named device)
against JAX's uncached device build, which numbers genes in read order,
short reads included (one read set puts genes on short reads before any
long read has them). Without a cache the port's constructor builds on the
card unless it is given a device.

Tolerance: zero; every field is compared exactly.
"""

import numpy as np
import pytest

from amira_tpu.graph import GeneMerGraph as JaxGraph
from amira_tpu.graph_cache import GraphBuildCache as JaxCache
from amira_tpu.vocab import GeneVocab as JaxVocab
from amira_tpu_torch import graph as port_graph
from amira_tpu_torch.graph_cache import GraphBuildCache as PortCache
from amira_tpu_torch.ops import graph_tables, host_tables
from amira_tpu_torch.vocab import GeneVocab as PortVocab
from synthetic import make_isolate


def assert_graphs_identical(a, b):
    assert list(a.get_nodes().keys()) == list(b.get_nodes().keys())
    for h, na in a.get_nodes().items():
        nb = b.get_nodes()[h]
        assert na.coverage == nb.coverage
        assert na.tokens.tolist() == nb.tokens.tolist()
        assert na.reads == nb.reads
        assert na.fwd_edges == nb.fwd_edges
        assert na.bwd_edges == nb.bwd_edges
        assert na.component == nb.component
    assert list(a.get_edges().keys()) == list(b.get_edges().keys())
    for k, ea in a.get_edges().items():
        eb = b.get_edges()[k]
        assert (ea.src, ea.tgt, ea.src_dir, ea.tgt_dir, ea.coverage) == (
            eb.src, eb.tgt, eb.src_dir, eb.tgt_dir, eb.coverage
        )
    assert a.get_readNodes() == b.get_readNodes()
    assert a.get_readNodeDirections() == b.get_readNodeDirections()
    assert a.get_readNodePositions() == b.get_readNodePositions()
    assert a.get_short_read_annotations() == b.get_short_read_annotations()


def _random_reads(seed, n_reads=120, n_genes=30):
    rng = np.random.RandomState(seed)
    genome = [f"g{i}" for i in range(n_genes)]
    calls, positions = {}, {}
    for r in range(n_reads):
        L = rng.randint(1, 12)
        s = rng.randint(0, n_genes - L + 1)
        genes = [("+" if rng.rand() < 0.8 else "-") + g for g in genome[s : s + L]]
        if rng.rand() < 0.3:  # read from the other strand
            genes = [("-" if g[0] == "+" else "+") + g[1:] for g in reversed(genes)]
        if rng.rand() < 0.2 and L > 2:  # a miscalled gene
            genes[rng.randint(0, L)] = f"+err{rng.randint(0, 5)}"
        calls[f"r{r}"] = genes
        positions[f"r{r}"] = [[i * 100, i * 100 + 99] for i in range(L)]
    return calls, positions


def _short_first_reads(seed, n_reads=100, n_genes=24):
    """Reads where short ones (fewer genes than k = 7, often than 3) come
    first and carry genes that long reads only have later: the gene ids of
    a build that interns short reads differ from one that skips them."""
    rng = np.random.RandomState(seed)
    calls, positions = {}, {}
    for r in range(n_reads):
        if r < n_reads // 4:
            L = rng.randint(1, 7)
            pool = range(n_genes // 2, n_genes)  # genes the long reads reach last
        else:
            L = rng.randint(7, 14)
            pool = range(n_genes)
        genes = [("+" if rng.rand() < 0.7 else "-") + f"s{rng.choice(pool)}" for _ in range(L)]
        calls[f"q{r}"] = genes
        positions[f"q{r}"] = [[i * 100, i * 100 + 99] for i in range(L)]
    return calls, positions


def _isolate_reads(tmp_path, seed):
    import json

    files = make_isolate(str(tmp_path / "iso"), seed=seed, n_reads=60)
    return json.load(open(files["calls"])), json.load(open(files["positions"]))


def _mutate(calls, positions, seed):
    """A cleaning-iteration-like rebuild input: some reads dropped, some
    re-annotated (fresh lists), the rest the same objects."""
    rng = np.random.RandomState(seed)
    new_c, new_p = {}, {}
    for rid, genes in calls.items():
        x = rng.rand()
        if x < 0.1:
            continue
        if x < 0.3 and len(genes) > 1:
            j = rng.randint(0, len(genes))
            new_c[rid] = genes[:j] + genes[j + 1 :]
            new_p[rid] = positions[rid][:j] + positions[rid][j + 1 :]
        else:
            new_c[rid] = genes
            new_p[rid] = positions[rid]
    return new_c, new_p


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("source", ["random", "isolate", "short_first"])
@pytest.mark.parametrize("reference_build", ["cached", "uncached"])
def test_cold_build_identical(k, source, reference_build, tmp_path):
    """A port graph built as a caller builds it, against the JAX package's
    build through a cache (the pipeline's path) with the port's build
    through a cache, and against its uncached device build with the port's
    build without one. Fresh vocabularies on both sides: the uncached
    builds intern every read's genes in read order, short reads included,
    the cached ones skip short reads."""
    if source == "random":
        calls, positions = _random_reads(k)
    elif source == "short_first":
        calls, positions = _short_first_reads(k)
    else:
        calls, positions = _isolate_reads(tmp_path, k)
    if reference_build == "uncached":
        ref = JaxGraph(calls, k, positions, vocab=JaxVocab())
        got = port_graph.GeneMerGraph(calls, k, positions, vocab=PortVocab(), device="cpu")
    else:
        ref = JaxGraph(calls, k, positions, vocab=JaxVocab(), cache=JaxCache())
        got = port_graph.GeneMerGraph(
            calls, k, positions, vocab=PortVocab(), cache=PortCache("cpu")
        )
    assert got.is_lazy == ref.is_lazy
    assert got.get_total_number_of_nodes() == len(ref.get_nodes())
    assert got.get_total_number_of_edges() == len(ref.get_edges())
    assert_graphs_identical(ref, got)
    if source == "short_first" and k > 3:
        # where short reads introduce genes, the two JAX builds number them
        # differently, so this case tells them apart
        other = (
            JaxGraph(calls, k, positions, vocab=JaxVocab(), cache=JaxCache())
            if reference_build == "uncached"
            else JaxGraph(calls, k, positions, vocab=JaxVocab())
        )
        assert list(other.get_nodes()) != list(ref.get_nodes())


def test_uncached_build_asks_for_the_card(monkeypatch):
    """F6: without a cache and without a device the constructor resolves
    "cuda", which raises on a machine without CUDA; with a named device it
    groups its tables there and builds an eager graph."""
    import torch

    calls, positions = _random_reads(3, n_reads=10)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        port_graph.GeneMerGraph(calls, 3, positions)
    asked = []
    real = graph_tables.assemble_node_tables

    def recording(occ_hash, occ_read, occ_key):
        asked.append(occ_hash.device)
        return real(occ_hash, occ_read, occ_key)

    monkeypatch.setattr(graph_tables, "assemble_node_tables", recording)
    graph = port_graph.GeneMerGraph(calls, 3, positions, device="cpu")
    assert asked == [torch.device("cpu")]
    assert not graph.is_lazy and graph.lazy_tables() is None
    assert graph.get_total_number_of_nodes() > 0


@pytest.mark.parametrize(
    "k,device_windows", [(3, False), (5, False), (7, False), (3, True)]
)
def test_cached_rebuilds_identical(k, device_windows, monkeypatch):
    if device_windows:
        # every miss batch through the torch flat-stream windowing
        monkeypatch.setattr(host_tables, "HOST_BATCH_GENE_LIMIT", 0)
    calls, positions = _random_reads(10 + k, n_reads=200)
    jv, pv = JaxVocab(), PortVocab()
    jc, pc = JaxCache(), PortCache("cpu")
    runs_before = graph_tables.DEVICE_RUNS["cpu"]
    for step in range(3):
        ref = JaxGraph(calls, k, positions, vocab=jv, cache=jc)
        got = port_graph.GeneMerGraph(calls, k, positions, vocab=pv, cache=pc)
        assert (pc.hits, pc.misses) == (jc.hits, jc.misses)
        assert_graphs_identical(ref, got)
        calls, positions = _mutate(calls, positions, step)
    ran = graph_tables.DEVICE_RUNS["cpu"] - runs_before
    assert ran == (3 if device_windows else 0)
