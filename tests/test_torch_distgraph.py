"""The port's distributed graph build (`amira_tpu_torch.parallel.distgraph`,
what --dist-build runs) against the JAX package's on the CPU.

`distributed_graph_build` over 1, 2 and 4 CPU shards must equal the JAX
package's over ("data",) meshes of 1, 2 and 4 of the test session's 8 CPU
devices: node hashes in insertion order, coverages, read lists, canonical
tokens and edge lists, edges with their endpoints, directions and
coverage, readNodes and readNodePositions. The reads are random gene lists
(the generator of tests/test_parallel.py), a set with more than 16k unique
nodes, and reads at k = 5 with reads shorter than k among them. Hashes are
held to the JAX distributed build's, which numbers genes in its own order
(it tokenizes short reads too). `bounded_count_min` is held to the JAX
package's on keys of 2^63 and above, and the CLI with --dist-build over
four CPU shards writes the single-device TSV and the JAX package's
--dist-build TSV.

Tolerance: zero; every comparison is exact.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from amira_tpu.parallel import distgraph as jax_distgraph
from amira_tpu.vocab import GeneVocab as JaxVocab
from amira_tpu_torch import pipeline
from amira_tpu_torch.parallel import distgraph
from amira_tpu_torch.vocab import GeneVocab
from synthetic import make_isolate


def _random_reads(seed, n_reads, n_genes, min_len, max_len):
    """{read id: stranded gene names}, as tests/test_parallel.py draws them,
    and gene positions for each read (consecutive 400-base genes)."""
    rng = np.random.RandomState(seed)
    reads = {
        f"r{i}": [
            ("+" if rng.rand() < 0.5 else "-") + f"g{rng.randint(1, n_genes)}"
            for _ in range(rng.randint(min_len, max_len))
        ]
        for i in range(n_reads)
    }
    positions = {
        rid: [(500 * j, 500 * j + 399) for j in range(len(genes))]
        for rid, genes in reads.items()
    }
    return reads, positions


# name: (k, read generator arguments)
CASES = {
    "random_k3": (3, dict(seed=5, n_reads=80, n_genes=40, min_len=3, max_len=14)),
    "past_16k_nodes": (3, dict(seed=11, n_reads=4000, n_genes=400, min_len=10, max_len=11)),
    "k5_short_reads": (5, dict(seed=7, n_reads=120, n_genes=30, min_len=1, max_len=16)),
}


def _graph_state(g):
    """Everything the comparison holds equal, as plain Python values."""
    nodes = [
        (h, n.coverage, list(n.reads), [int(t) for t in n.tokens],
         list(n.fwd_edges), list(n.bwd_edges))
        for h, n in g.get_nodes().items()
    ]
    edges = [
        (key, e.src, e.tgt, e.src_dir, e.tgt_dir, e.coverage)
        for key, e in g.get_edges().items()
    ]
    return {
        "nodes": nodes,
        "edges": edges,
        "readNodes": g.get_readNodes(),
        "readNodePositions": g.get_readNodePositions(),
        "short": g.get_short_read_annotations(),
    }


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_distributed_build_equals_jax_distributed_build(case, shards):
    k, kwargs = CASES[case]
    reads, positions = _random_reads(**kwargs)
    mesh = Mesh(np.array(jax.devices()[:shards]).reshape(shards), ("data",))
    ref = jax_distgraph.distributed_graph_build(
        dict(reads), k, mesh, vocab=JaxVocab(), gene_positions=positions
    )
    got = distgraph.distributed_graph_build(
        dict(reads), k, ["cpu"] * shards, vocab=GeneVocab(), gene_positions=positions
    )
    want = _graph_state(ref)
    assert _graph_state(got) == want
    hashes = [n[0] for n in want["nodes"]]
    assert max(hashes) >= 1 << 63  # unsigned order was exercised
    if case == "past_16k_nodes":
        assert len(hashes) > 1 << 14
    if case == "k5_short_reads":
        assert want["short"]


@pytest.mark.parametrize("seed", [0, 1])
def test_bounded_count_min_equals_jax_on_high_keys(seed):
    rng = np.random.RandomState(seed)
    n = 4000
    pool = rng.randint(0, 1 << 62, size=300, dtype=np.int64).astype(np.uint64)
    pool[::2] |= np.uint64(1 << 63)  # half the keys at 2^63 and above
    pool[:3] = [1, (1 << 63) - 1, 1 << 63]
    keys = pool[rng.randint(0, len(pool), size=n)]
    keys[rng.rand(n) < 0.1] = 0  # invalid entries
    weights = rng.randint(1, 9, size=n).astype(np.int32)
    orderkeys = rng.permutation(n * 7)[:n].astype(np.uint64)
    ref_k, ref_c, ref_f = (
        np.asarray(x)
        for x in jax_distgraph.bounded_count_min(keys, weights, orderkeys, n)
    )
    live = ref_k != 0
    got_k, got_c, got_f = distgraph.bounded_count_min(
        torch.from_numpy(keys.view(np.int64)), torch.from_numpy(weights),
        torch.from_numpy(orderkeys.view(np.int64)),
    )
    assert np.array_equal(got_k.numpy().view(np.uint64), ref_k[live])
    assert np.array_equal(got_c.numpy(), ref_c[live].astype(np.int64))
    assert np.array_equal(got_f.numpy(), ref_f[live].astype(np.int64))
    assert (ref_k[live] >= np.uint64(1 << 63)).any()


def _argv(files, outdir):
    return [
        "--pandoraJSON", files["calls"],
        "--gene-positions", files["positions"],
        "--reads", files["fastq"],
        "--species", "Escherichia_coli",
        "--amr-fasta", files["amr_fasta"],
        "--amr-calls", files["amr_calls"],
        "--core-genes", files["core_genes"],
        "--plasmid-genes", files["plasmid_genes"],
        "--output", outdir,
        "--quiet",
    ]


def _run(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        assert e.code in (None, 0)
    return open(os.path.join(argv[argv.index("--output") + 1], "amira_results.tsv")).read()


@pytest.fixture(scope="module")
def isolate(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    return make_isolate(str(d / "data"), seed=3, n_reads=70), d


def _count_dist_builds(monkeypatch):
    calls = []
    real = pipeline.distributed_graph_build

    def counting(reads, k, devices, **kwargs):
        calls.append((k, [str(d) for d in devices]))
        return real(reads, k, devices, **kwargs)

    monkeypatch.setattr(pipeline, "distributed_graph_build", counting)
    return calls


def test_dist_build_cli_tsv_equals_single_device_and_jax(isolate, monkeypatch):
    from amira_tpu.__main__ import main as jax_main
    from amira_tpu_torch.__main__ import main

    files, d = isolate
    single = _run(main, _argv(files, str(d / "single")) + ["--device", "cpu"])
    calls = _count_dist_builds(monkeypatch)
    monkeypatch.setattr(pipeline, "visible_devices", lambda t: [torch.device(t)] * 4)
    dist = _run(main, _argv(files, str(d / "dist")) + ["--device", "cpu", "--dist-build"])
    jax_dist = _run(jax_main, _argv(files, str(d / "jax_dist")) + ["--dist-build"])
    assert len(calls) == 2  # the initial and the final build
    assert calls[0] == (3, ["cpu"] * 4)
    assert dist == single == jax_dist
    assert "amrX" in dist


@pytest.mark.parametrize(
    "flag,n_devices,distributed",
    [(None, 2, True), (None, 1, False), ("--dist-build", 1, False),
     ("--no-dist-build", 2, False)],
)
def test_dist_build_default_follows_visible_devices(
    isolate, monkeypatch, flag, n_devices, distributed
):
    """Two or more visible devices build distributed unless --no-dist-build
    is given (the JAX package's default); one device builds alone, even
    with --dist-build (the CLI test above covers --dist-build on four)."""
    from amira_tpu_torch.__main__ import main

    files, d = isolate
    calls = _count_dist_builds(monkeypatch)
    monkeypatch.setattr(pipeline, "visible_devices", lambda t: [torch.device(t)] * n_devices)
    argv = _argv(files, str(d / f"default_{flag}_{n_devices}")) + ["--device", "cpu"]
    tsv = _run(main, argv + ([flag] if flag else []))
    assert len(calls) == (2 if distributed else 0)
    assert "amrX" in tsv
