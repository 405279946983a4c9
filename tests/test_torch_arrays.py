"""AMR genes in arrays: the port's path clustering, allele FASTQs,
polishing and copy number on an isolate whose AMR genes sit next to each
other, held to the JAX package and to the truth.

The isolate comes from the benchmark's generator (`benchmark/generate.py`)
at a small size: a 60-gene genome with one array of four AMR genes at two
loci, the second with a fifth AMR gene inside it, and one AMR gene alone
(as the integron cassettes of a multidrug-resistant K. pneumoniae sit).
Both packages run it through their CLIs on the CPU; their
`amira_results.tsv` and every row's `06.final_sequence.fasta` must be
equal byte for byte, the benchmark's plain reference (`benchmark/
reference.py`) must find every copy with its true closest reference, and
each locus of the array must be where most of the polishing reads of
exactly one row of each array gene come from. A read's locus is told by
the non-AMR genes that flank its array in its true calls. One case names
the genes as the AMR panel does, with "(", "'" and "-" in them.

Tolerance: zero; files are compared byte for byte and counts exactly.
"""

import collections
import csv
import gzip
import importlib.util
import json
import os

import numpy as np
import pytest

import amira_tpu.cluster
import amira_tpu.graph
import amira_tpu.pipeline
import amira_tpu_torch.cluster
import amira_tpu_torch.graph
import amira_tpu_torch.pipeline
from amira_tpu.__main__ import main as jax_main
from amira_tpu_torch.__main__ import main as torch_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARRAY_LOCI = (12, 44)  # the array follows these genes; the second holds `inside`
LONE_LOCUS = 28
CASES = {
    "integron": (("aadA2", "dfrA12", "qacEdelta1", "sul1"), "blaTEM", "blaKPC"),
    "punctuated": (("aac(6')-Ib-cr", "arr-3", "blaOXA-1", "catB3"), "blaCTX-M-15", "aph(3'')-Ib"),
}


def _benchmark_module(name):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{name}", os.path.join(REPO, "benchmark", f"{name}.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _params(array, inside, lone):
    with open(os.path.join(REPO, "benchmark", "configs", "kpn_mdr.json")) as f:
        defaults = json.load(f)["defaults"]
    amr_after = {g: list(ARRAY_LOCI) for g in array}
    amr_after[inside] = [ARRAY_LOCI[1]]
    amr_after[lone] = [LONE_LOCUS]
    # reads of 6-12 genes never hold both loci; ~300 x 9 / 70 slots, ~40x
    return {
        "species": "Klebsiella_pneumoniae", "route": "json", "genes": 60, "gene_len": 500,
        "amr_after": amr_after, "allele_divergence": 0.04, "reads": 300,
        "genes_per_read": [6, 12], "sub": 0.02, "indel": 0.01, "reverse_fraction": 0.3,
        "call_noise": 0.05, "defaults": defaults,
    }


def _argv(params, files, out):
    argv = [
        "--pandoraJSON", files["calls"], "--gene-positions", files["positions"],
        "--reads", files["fastq"], "--species", params["species"],
        "--amr-fasta", files["amr_fasta"], "--amr-calls", files["amr_calls"],
        "--core-genes", files["core_genes"], "--plasmid-genes", files["plasmid_genes"],
        "--output", out, "--quiet",
        "-n", str(params["defaults"]["node_min_coverage"]),
        "-g", str(params["defaults"]["gene_min_coverage"]),
        "--seed", str(params["defaults"]["seed"]),
    ]
    return argv


@pytest.fixture(scope="module", params=sorted(CASES))
def array_run(request, tmp_path_factory):
    """(params, files with truth, the port's output dir, the JAX package's)."""
    array, inside, lone = CASES[request.param]
    params = _params(array, inside, lone)
    d = tmp_path_factory.mktemp(f"arrays_{request.param}")
    files = _benchmark_module("generate").make_isolate(str(d / "data"), 3517000017, params)
    outs = {}
    for name, main, extra in (("torch", torch_main, ["--device", "cpu"]), ("jax", jax_main, [])):
        outs[name] = str(d / name)
        main(_argv(params, files, outs[name]) + extra)
    return params, files, outs["torch"], outs["jax"]


def _rows(out):
    with open(os.path.join(out, "amira_results.tsv"), newline="") as f:
        return list(csv.DictReader(f, delimiter="\t"))


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_port_matches_the_jax_package_on_an_array_isolate(array_run):
    _params, _files, port, jax = array_run
    assert _read(os.path.join(port, "amira_results.tsv")) == _read(os.path.join(jax, "amira_results.tsv"))
    alleles = [r["Amira allele"] for r in _rows(port)]
    assert len(alleles) == 10
    for a in alleles:
        rel = os.path.join("AMR_allele_fastqs", a, "06.final_sequence.fasta")
        assert _read(os.path.join(port, rel)) == _read(os.path.join(jax, rel)), a


def test_truth_judge_finds_every_copy(array_run):
    _params, files, port, _jax = array_run
    nums = _benchmark_module("reference").judge(port, files["truth"])
    assert nums["copies_missing"] == 0
    assert nums["refs_off"] == 0
    assert nums["copies_extra"] == 0 and nums["rows_repeated"] == 0
    assert nums["writes_missing"] == 0


def _read_names(path):
    with gzip.open(path, "rt") as f:
        return [line[1:].split()[0] for i, line in enumerate(f) if i % 4 == 0]


def test_each_array_locus_is_the_majority_source_of_one_row(array_run):
    params, files, port, _jax = array_run
    truth = files["truth"]
    names = truth["gene_names"]
    genes_of = collections.defaultdict(set)
    for r, g in zip(truth["calls"][0].tolist(), truth["calls"][1].tolist()):
        genes_of[f"read{r}"].add(names[g])
    flanks = {locus: {f"gene{locus}", f"gene{locus + 1}"} for locus in ARRAY_LOCI}
    array = [g for g, loci in params["amr_after"].items() if list(loci) == list(ARRAY_LOCI)]
    assert len(array) == 4
    for gene in array:
        rows = [r for r in _rows(port) if r["Determinant name"] == gene]
        majority = []
        for r in rows:
            a = r["Amira allele"]
            reads = _read_names(os.path.join(port, "AMR_allele_fastqs", a, f"{a}.fastq.gz"))
            by_locus = collections.Counter(
                locus for read in reads for locus, f in flanks.items() if genes_of[read] & f
            )
            (top, n), = by_locus.most_common(1)
            assert n > len(reads) / 2, (a, dict(by_locus))
            majority.append(top)
        assert sorted(majority) == sorted(ARRAY_LOCI), (gene, majority)


@pytest.mark.parametrize("inside", [None, "blaTEM"])
def test_clustering_of_an_array_at_two_loci_matches_the_jax_package(inside):
    """`assign_reads_to_genes` on reads of one array at two loci (with an
    AMR gene inside the second, or not): the same alleles, members and path
    support in both packages, one allele for each locus of each array gene."""
    array = ["+aac(6')-Ib-cr", "-arr-3"]
    second = array + ([f"+{inside}"] if inside else [])
    reads = {}
    for i in range(6):
        reads[f"read{i}"] = ["+gene1", "-gene2", "+gene3"] + array + ["+gene4", "-gene5"]
        reads[f"read{i + 6}"] = ["+gene9", "-gene10", "+gene11"] + second + ["+gene12", "-gene13"]
    positions = {r: [(j * 100, j * 100 + 99) for j in range(len(g))] for r, g in reads.items()}
    genes = sorted({g[1:] for g in array + second})
    results = []
    for cluster, graph in (
        (amira_tpu.cluster, amira_tpu.graph.GeneMerGraph(reads, 3, positions)),
        (amira_tpu_torch.cluster, amira_tpu_torch.graph.GeneMerGraph(reads, 3, positions, device="cpu")),
    ):
        results.append(cluster.assign_reads_to_genes(graph, genes, 1, {}, graph.get_mean_node_coverage()))
    assert results[0] == results[1]
    clustered, _path_reads = results[1]
    for gene in ("aac(6')-Ib-cr", "arr-3"):
        alleles = [a for comp in clustered.values() for a in comp.get(gene, {}).values()]
        reads_of = sorted(sorted({m.rsplit("_", 2)[0] for m in members}) for members in alleles)
        assert reads_of == [[f"read{i}" for i in range(6)], sorted(f"read{i}" for i in range(6, 12))]


def test_cleaning_writes_no_neighbour_gene_in_place_of_a_correct_call(tmp_path):
    """Bubble popping corrects a read onto the higher path only where the
    read holds the lower path's whole difference from it. On this isolate
    (array A at two loci at ~100x, seed 6) two erroneous paths near the
    second locus, one dropping a gene and one dropping its neighbour, form a
    bubble; the JAX package splices the higher one over reads that share
    only the correct part of the lower one and writes a gene twice in a row
    in 112 reads. The port writes no gene twice in a row, and its clusters
    still hold one allele for each of the 15 copies."""
    with open(os.path.join(REPO, "benchmark", "configs", "kpn_mdr.json")) as f:
        params = json.load(f)
    params.update(genes=100, reads=800, genes_per_read=[10, 20], sub=0.02, indel=0.01,
                  reverse_fraction=0.3, call_noise=0.05)
    params["amr_after"] = {g: [i * 100 // 5300 for i in loci] for g, loci in params["amr_after"].items()}
    files = _benchmark_module("generate").make_isolate(str(tmp_path / "data"), 6, params)

    class Clustered(Exception):
        pass

    def repeats(out):
        with open(os.path.join(out, "corrected_gene_calls.json")) as f:
            calls = json.load(f)
        return sum(a[1:] == b[1:] for c in calls.values() for a, b in zip(c, c[1:]))

    alleles = {}
    for name, pipeline, main, extra in (
        ("torch", amira_tpu_torch.pipeline, torch_main, ["--device", "cpu"]),
        ("jax", amira_tpu.pipeline, jax_main, []),
    ):
        def stop(clusters, *a, _name=name, **k):
            per_gene = collections.Counter()
            for comp in clusters.values():
                for g, by_allele in comp.items():
                    per_gene[g] += len(by_allele)
            alleles[_name] = sorted(per_gene.items())
            raise Clustered()

        out = str(tmp_path / name)
        real = pipeline.write_fastqs_for_genes
        pipeline.write_fastqs_for_genes = stop
        try:
            with pytest.raises(Clustered):
                main(_argv(params, files, out) + extra)
        finally:
            pipeline.write_fastqs_for_genes = real
        alleles[name + "_repeats"] = repeats(out)
    assert alleles["jax_repeats"] == 112
    assert alleles["torch_repeats"] == 0
    copies = sorted((g, len(loci)) for g, loci in params["amr_after"].items())
    assert alleles["torch"] == copies


class _Sketch:
    """One node's sketch: the same hashes on every node, so any two paths
    are contained in each other."""

    hashes = {1, 2, 3}
    _arr = np.array([1, 2, 3], np.uint64)


def _two_wrong_paths(graph_cls):
    """A graph of 20 correct reads through +g1..+g12, 4 reads that flip g5
    and 6 that drop g7, and the bubble that the two wrong paths form
    between their shared terminals (g2, g3, g4) and (g8, g9, g10), with
    the drop path as the higher one."""
    true = [f"+g{i}" for i in range(1, 13)]
    flip = true[:4] + ["-g5"] + true[5:]
    drop = true[:6] + true[7:]
    reads = {f"t{i}": list(true) for i in range(20)}
    reads.update({f"f{i}": list(flip) for i in range(4)})
    reads.update({f"d{i}": list(drop) for i in range(6)})
    positions = {r: [(j * 1000, j * 1000 + 900) for j in range(len(c))] for r, c in reads.items()}
    graph = graph_cls(reads, 3, positions)
    fastq = {r: {"sequence": "A" * 12000, "quality": "I" * 12000} for r in reads}

    def bubble_path(read, first, last):
        nodes = graph.get_readNodes()[read]
        dirs = graph.get_readNodeDirections()[read]
        return [(nodes[i], dirs[i]) for i in range(first, last + 1)]

    # gene-mer i of a read starts at its gene i: (g2, g3, g4) is gene-mer 1
    lower = bubble_path("f0", 1, 7)
    higher = bubble_path("d0", 1, 6)
    assert lower[0][0] == higher[0][0] and lower[-1][0] == higher[-1][0]
    sketches = {tuple(n for n, _ in p): [_Sketch()] for p in (lower, higher)}
    bubbles = {(lower[0][0], lower[-1][0]): [(higher, 12.0), (lower, 10.0)]}
    return graph, fastq, bubbles, sketches, true, drop


@pytest.mark.parametrize("package", ["amira_tpu", "amira_tpu_torch"])
def test_bubble_of_two_wrong_paths_leaves_correct_reads_alone(package):
    """Both paths of a bubble can be wrong, each at its own column: one
    flips g5, the other drops g7, and the lower (flip) path holds the true
    g7. Reads through the lower path's nodes include every correct read
    that passes g6-g8; a correct read leaves the lower path at g5, so the
    port leaves it as it is and corrects only the flip reads. The JAX
    package splices the higher path over the correct reads too and drops
    their g7 (ROADMAP Queue 1)."""
    if package == "amira_tpu":
        from amira_tpu import bubbles
        from amira_tpu.graph import GeneMerGraph as graph_cls
    else:
        from amira_tpu_torch import bubbles

        def graph_cls(reads, k, positions):
            return amira_tpu_torch.graph.GeneMerGraph(reads, k, positions, device="cpu")

    graph, fastq, bubble, sketches, true, drop = _two_wrong_paths(graph_cls)
    bubbles.correct_bubble_paths(graph, bubble, fastq, sketches, set(), 1)
    reads = graph.get_reads()
    assert [reads[f"f{i}"] for i in range(4)] == [drop] * 4
    assert [reads[f"d{i}"] for i in range(6)] == [drop] * 6
    held = [reads[f"t{i}"] for i in range(20)]
    assert held == ([drop] * 20 if package == "amira_tpu" else [true] * 20)
