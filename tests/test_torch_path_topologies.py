"""The full-path topologies of tests/test_path_topologies.py on the port's
clustering (`amira_tpu_torch.cluster`, its graph built without a cache on
the CPU): on the same reads its anchors, blocks, block counts, seen nodes
and path coverages equal `amira_tpu`'s, and its blocks keep the corpus's
counts."""

import json
import os

import pytest

import amira_tpu.cluster
import amira_tpu.graph
import amira_tpu_torch.cluster
import amira_tpu_torch.graph
from test_path_topologies import REF


def full_paths(cluster, graph, gene, threshold, subset_to_gene_reads):
    nodes = graph.get_nodes_containing(gene)
    node_hashes = [n.hash for n in nodes]
    if subset_to_gene_reads:
        wanted = graph.collect_reads_in_path(node_hashes)
        node_index = cluster.construct_node_index(
            {r: graph.get_readNodes()[r] for r in wanted}
        )
        calls = {r: graph.get_reads()[r] for r in wanted}
    else:
        node_index = cluster.construct_node_index(dict(graph.get_readNodes()))
        calls = dict(graph.get_reads())
    calls.update(
        {r + "_reverse": graph.reverse_list_of_genes(calls[r]) for r in list(calls)}
    )
    anchors = cluster.get_AMR_anchors(graph, node_hashes)
    blocks, seen, covs = cluster.get_full_paths(
        graph, node_index, anchors, threshold, calls, gene
    )
    return anchors, blocks, seen, covs


def port_paths(reads, gene, threshold=1, positions=None, subset_to_gene_reads=False,
               singletons=False):
    """The port's (anchors, blocks, seen, coverages) on `reads`, held equal
    to the JAX package's on the same reads first."""
    sides = []
    for cluster, graph in (
        (amira_tpu.cluster, amira_tpu.graph.GeneMerGraph(reads, 3, positions)),
        (
            amira_tpu_torch.cluster,
            amira_tpu_torch.graph.GeneMerGraph(reads, 3, positions, device="cpu"),
        ),
    ):
        anchors, blocks, seen, covs = full_paths(
            cluster, graph, gene, threshold, subset_to_gene_reads
        )
        if singletons:
            blocks = dict(blocks)
            covs = dict(covs)
            cluster.get_singleton_paths(graph, seen, anchors, blocks, covs)
        sides.append((set(anchors), blocks, set(seen), covs))
    jax_side, port = sides
    assert port[0] == jax_side[0]
    assert port[1] == jax_side[1]
    assert port[2] == jax_side[2]
    assert port[3] == jax_side[3]
    return port


def test_one_adjacent_path():
    genes1 = ["+gene1", "-gene2", "+gene4", "-gene4", "-gene4", "+gene7", "-gene8"]
    genes2 = (
        ["+gene-1", "-gene0"]
        + genes1
        + ["+gene9", "-gene10" "+gene11"]  # sic: concatenated literal, as in the corpus
    )
    reads = {"read1": genes1, "read2": genes1, "read3": genes2, "read4": genes2}
    _a, blocks, _s, _c = port_paths(reads, "gene4")
    assert len(blocks) == 1
    assert all(count == 4 for count in blocks.values())


def _junction_reads(core_repeats, trailing_blc=False):
    tandem = ["+sugE", "-blc", "-blaCMY54NG_0488491"] * core_repeats
    if trailing_blc:
        tandem += ["+sugE", "-blc"]
    genes1 = (
        ["-trbC", "-trbB", "-group_1081", "-group_6156"]
        + tandem
        + ["-group_5175", "+group_5625"]
    )
    genes2 = [
        "-alkB", "-ada", "-apbE", "-ompC",
        "+sugE", "-blc", "-blaCMY54NG_0488491",
        "+rcsD", "+rcsB", "-rcsC", "+atoS", "+atoC", "+atoD", "+atoA",
        "+atoE", "+atoB", "-yfaP", "-yfaQ",
    ]
    return {"read1": genes1, "read2": genes1, "read3": genes2, "read4": genes2}


def test_terminate_at_junction():
    reads = _junction_reads(core_repeats=6)
    _a, blocks, _s, _c = port_paths(reads, "blaCMY54NG_0488491")
    assert len(blocks) == 2
    for path, count in blocks.items():
        assert len(path) in (5, 20)
        assert count == 2


def test_terminate_and_start_at_junction():
    reads = _junction_reads(core_repeats=6, trailing_blc=True)
    _a, blocks, _s, _c = port_paths(reads, "blaCMY54NG_0488491")
    assert len(blocks) == 2
    for path, count in blocks.items():
        assert len(path) in (5, 20)
        assert count == 2


def test_singleton_read_yields_no_blocks_then_singleton_path():
    genes = ["+gene7", "-gene4", "-gene13"]
    reads = {"read1": genes, "read2": genes}
    anchors, blocks, _s, _c = port_paths(reads, "gene7")
    assert len(anchors) == 1
    assert len(blocks) == 0
    _a, blocks, _s, _c = port_paths(reads, "gene7", singletons=True)
    assert len(blocks) == 1
    assert all(count == 2 for count in blocks.values())


def test_branching_path():
    genes1 = [
        "+gene1", "-gene2", "+gene3", "-gene5", "-gene6", "+gene7",
        "-gene4", "-gene6", "+gene7", "-gene10", "-gene11",
    ]
    genes2 = [
        "+gene1", "-gene2", "+gene3", "-gene5", "-gene6", "+gene7",
        "-gene4", "-gene13", "+gene14", "-gene15", "-gene16",
    ]
    genes3 = ["+gene7", "-gene4", "-gene13"]
    reads = {
        "read1": genes1, "read2": genes1, "read3": genes2,
        "read4": genes2, "read5": genes3,
    }
    _a, blocks, _s, _c = port_paths(reads, "gene7", threshold=2)
    assert len(blocks) == 2
    for path, count in blocks.items():
        assert len(path) in (3, 8)
        assert count in (2, 3)


def test_triangle():
    mid1 = ["+gene5", "+gene7"] * 3
    mid2 = ["+gene5", "+gene7"]
    mid3 = ["+gene5", "+gene7"] * 2
    pre = ["+gene1", "-gene2", "+gene3", "-gene4"]
    post = ["-gene8", "+gene9", "-gene10", "+gene11"]
    reads = {
        "read1": pre + mid1 + post, "read2": pre + mid1 + post,
        "read3": pre + mid2 + post, "read4": pre + mid2 + post,
        "read5": pre + mid3 + post, "read6": pre + mid3 + post,
    }
    _a, blocks, _s, _c = port_paths(reads, "gene5")
    assert len(blocks) == 3
    for path, count in blocks.items():
        assert len(path) in (5, 7, 9)
        assert count == 2


def test_linear_path_duplicates_long_reads():
    genes1 = [
        "+gene1", "-gene2", "+gene3", "-gene4", "+gene5", "-gene6",
        "+gene7", "-gene8", "+gene9", "+gene4", "-gene10", "+gene11",
        "-gene12",
    ]
    genes2 = ["-gene2", "+gene3", "-gene4"]
    genes3 = ["+gene4", "-gene10", "+gene11"]
    reads = {"read1": genes1, "read2": genes1, "read3": genes2, "read4": genes3}
    _a, blocks, _s, _c = port_paths(reads, "gene4")
    assert len(blocks) == 1
    for path, count in blocks.items():
        assert len(path) == 11
        assert count == 2


def test_diverging_paths_at_terminals():
    core = ["+gene5", "-gene6", "+gene7", "-gene8", "+gene9", "-gene10", "+gene11"]
    genes1 = ["+gene1", "-gene2", "+gene3", "-gene4"] + core + [
        "-gene12", "+gene13", "-gene14", "+gene15"
    ]
    genes2 = ["+gene16", "-gene17", "+gene18", "-gene19"] + core + [
        "-gene20", "+gene21", "-gene22", "+gene23"
    ]
    reads = {f"read{i}": genes1 for i in (1, 2, 3)}
    reads.update({f"read{i}": genes2 for i in (4, 5, 6)})
    _a, blocks, _s, _c = port_paths(reads, "gene8")
    assert len(blocks) == 2
    for path, count in blocks.items():
        assert len(path) == 9
        assert count == 3


def test_multi_tandem():
    helper = amira_tpu_torch.graph.GeneMerGraph({}, 3, device="cpu")
    read1 = (
        ["+gene1", "-gene2", "+gene3"] + ["-gene4"] * 6
        + ["+gene5", "-gene6", "+gene7", "-gene8", "+gene9"]
    )
    read2 = (
        ["+gene1", "-gene2", "+gene3"] + ["-gene4"] * 9
        + ["+gene5", "-gene6", "+gene7", "-gene8", "+gene9"]
    )
    read3 = ["-gene2", "+gene3"] + ["-gene4"] * 6 + ["+gene5", "-gene6"]
    read4 = ["+gene3"] + ["-gene4"] * 9 + ["+gene5"]
    read5 = ["+gene1", "-gene2", "+gene3", "-gene4", "-gene4", "-gene4"]
    read6 = ["-gene4"] * 5 + ["+gene5", "-gene6"]
    read7 = ["-gene4"] * 3
    read8 = ["+gene3"] + ["-gene4"] * 6 + ["+gene5"]
    read9 = ["-gene10", "+gene4", "-gene11"]
    read10 = ["-gene4"] * 9
    reads = {
        "read1": read1,
        "read2": read2,
        "read3": helper.reverse_list_of_genes(read3),
        "read4": helper.reverse_list_of_genes(read4),
        "read5": read5,
        "read6": read6,
        "read7": read7,
        "read8": read8,
        "read9": read9,
        "read10": read10,
        "read11": read10,
        "read12": read10,
        "read13": read10,
    }
    _a, blocks, _s, _c = port_paths(reads, "gene4")
    assert len(blocks) == 2
    for path, count in blocks.items():
        assert len(path) in (8, 9)
        assert count in (3, 6)


@pytest.mark.skipif(
    not os.path.exists(f"{REF}/complex_gene_calls_five.json"),
    reason="reference fixtures unavailable",
)
def test_edge_case_fixture_five():
    calls = json.load(open(f"{REF}/complex_gene_calls_five.json"))
    positions = json.load(open(f"{REF}/complex_gene_positions_five.json"))
    _a, blocks, _s, _c = port_paths(
        calls, "blaCTXM110NG_0489052", positions=positions
    )
    assert len(blocks) == 1
    for path, count in blocks.items():
        assert len(path) == 1
        assert count == 44


@pytest.mark.skipif(
    not os.path.exists(f"{REF}/complex_gene_calls_six.json"),
    reason="reference fixtures unavailable",
)
def test_variant_fixture_six():
    calls = json.load(open(f"{REF}/complex_gene_calls_six.json"))
    positions = json.load(open(f"{REF}/complex_gene_positions_six.json"))
    _a, blocks, _s, _c = port_paths(
        calls, "blaTEM239NG_0766451", positions=positions
    )
    assert len(blocks) == 2
    for path, count in blocks.items():
        assert len(path) == 2
        assert count in (9, 30)


@pytest.mark.skipif(
    not os.path.exists(f"{REF}/complex_gene_calls_seven.json"),
    reason="reference fixtures unavailable",
)
def test_end_with_self_loop_fixture_seven():
    calls = json.load(open(f"{REF}/complex_gene_calls_seven.json"))
    positions = json.load(open(f"{REF}/complex_gene_positions_seven.json"))
    _a, blocks, _s, _c = port_paths(
        calls, "blaIMI9NG_0491711", positions=positions, threshold=3,
        subset_to_gene_reads=True,
    )
    assert len(blocks) == 1
    for path, count in blocks.items():
        assert len(path) == 5
        assert count == 4
