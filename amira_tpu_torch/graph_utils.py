"""Pipeline-level graph helpers: the iterative cleaning loop, gene-mer size
selection, and the node-coverage trough estimator.

Reference: amira/graph_utils.py. The reference's joblib shard-merge build
(graph_utils.py:17-124) is replaced by the batched tensor build in
amira_tpu/graph.py (single call, no merge step needed on one host; the
multi-host collective merge lives in amira_tpu/parallel/).
"""

from __future__ import annotations

import sys

import numpy as np

from . import clean
from .graph import GeneMerGraph
from .tracing import TIMER


def build_graph(read_dict, kmer_size, gene_positions=None, vocab=None, cache=None, device=None):
    """`device` serves only a build without `cache` (see GeneMerGraph)."""
    return GeneMerGraph(
        read_dict, kmer_size, gene_positions, vocab=vocab, cache=cache, device=device
    )


def iterative_bubble_popping(
    new_annotatedReads,
    new_gene_position_dict,
    cleaning_iterations,
    geneMer_size,
    cores,
    short_reads,
    short_read_gene_positions,
    fastq_content,
    output_dir,
    node_min_coverage,
    sample_genesOfInterest,
    min_path_coverage,
    vocab=None,
    quiet=True,
    cache=None,
    device=None,
):
    """Iterate {rebuild, filter, correct, trim tips, pop bubbles} until the
    node count stops changing (amira/graph_utils.py:127-181). Each stage of
    each iteration is a span of the open phase: `clean.build`,
    `clean.filter_correct`, `clean.short_reads`, `clean.tips` and
    `clean.bubbles` (whose counters hold the sweep's own stage seconds)."""
    prev_nodes = 0
    components_to_skip: set = set()
    for this_iteration in range(cleaning_iterations):
        if not quiet:
            sys.stderr.write(
                f"\namira-tpu: graph cleaning iteration {this_iteration + 1}\n"
            )
        with TIMER.span("clean.build"):
            graph = build_graph(
                new_annotatedReads, geneMer_size, new_gene_position_dict, vocab, cache, device
            )
        with TIMER.span("clean.filter_correct"):
            if graph.is_lazy:
                # tensor path: filter + correction from the aggregation tables,
                # no Node/Edge materialization (amira_tpu/clean.py; parity with
                # the object path is pinned by tests/test_tensor_clean.py)
                new_annotatedReads, new_gene_position_dict = clean.filter_and_correct(
                    graph, node_min_coverage, fastq_content
                )
            else:
                graph.filter_graph(node_min_coverage, 1)
                new_annotatedReads, new_gene_position_dict = graph.correct_reads(
                    fastq_content
                )
        with TIMER.span("clean.build"):
            graph = build_graph(
                new_annotatedReads, geneMer_size, new_gene_position_dict, vocab, cache, device
            )
        if graph.get_total_number_of_nodes() == prev_nodes:
            break
        prev_nodes = graph.get_total_number_of_nodes()
        with TIMER.span("clean.short_reads"):
            short_reads.update(graph.get_short_read_annotations())
            short_read_gene_positions.update(graph.get_short_read_gene_positions())
        with TIMER.span("clean.tips"):
            if graph.is_lazy:
                new_annotatedReads, new_gene_position_dict = clean.tip_trim_and_correct(
                    graph, geneMer_size, fastq_content
                )
            else:
                graph.remove_short_linear_paths(geneMer_size)
                new_annotatedReads, new_gene_position_dict = graph.correct_reads(
                    fastq_content
                )
        with TIMER.span("clean.build"):
            graph = build_graph(
                new_annotatedReads, geneMer_size, new_gene_position_dict, vocab, cache, device
            )
        with TIMER.span("clean.short_reads"):
            short_reads.update(graph.get_short_read_annotations())
            short_read_gene_positions.update(graph.get_short_read_gene_positions())
        with TIMER.span("clean.bubbles"):
            (
                new_annotatedReads,
                new_gene_position_dict,
                _path_coverages,
                min_path_coverage,
            ) = graph.correct_low_coverage_paths(
                fastq_content,
                sample_genesOfInterest,
                cores,
                min_path_coverage,
                components_to_skip,
                True,
            )
    return new_annotatedReads, new_gene_position_dict


def estimate_min_path_coverage(node_coverages, filename=None):
    """Trough between the error peak and the signal peak of the node-coverage
    histogram (amira/graph_utils.py:184-255): bin width 5, log counts,
    Savitzky-Golay smoothing, first two peaks, argmin between them.

    The optional plot is written only when `filename` is given.
    """
    from scipy.signal import find_peaks, savgol_filter

    max_coverage = max(node_coverages)
    bins = np.arange(0, max_coverage + 5, 5)
    hist, bin_edges = np.histogram(node_coverages, bins=bins)
    x_values = 0.5 * (bin_edges[:-1] + bin_edges[1:])
    log_counts = np.log(hist + 1)
    window_length, poly_order = 31, 5
    if len(log_counts) < window_length:
        window_length = max(5, len(log_counts) // 2 * 2 - 1)
    smoothed = savgol_filter(log_counts, window_length, poly_order)
    peaks, _ = find_peaks(
        [min(smoothed)] + list(smoothed), [min(smoothed)], prominence=0.1
    )
    peaks = peaks - 1
    first_peak = int(np.where(x_values == x_values[peaks[0]])[0][0])
    second_peak = int(np.where(x_values == x_values[peaks[1]])[0][0])
    trough_index = (
        int(np.argmin(smoothed[first_peak : second_peak + 1])) + first_peak
    )
    trough_value = float(x_values[trough_index])
    if filename is not None:
        _plot_coverage_histogram(x_values, log_counts, smoothed, trough_value, filename)
    return trough_value


def _plot_coverage_histogram(x_values, log_counts, smoothed, trough, filename):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 6))
    plt.bar(
        x_values, log_counts, width=5, label="Counts",
        color="white", edgecolor="black", align="center",
    )
    plt.plot(x_values, smoothed, color="red", label="Smoothed counts")
    plt.axvline(x=trough, color="r", linestyle="--", label=f"Trough at x={trough:.2f}")
    plt.title("Histogram of node coverages with smoothed curve")
    plt.xlabel("Node coverage")
    plt.ylabel("Log of absolute frequency")
    plt.legend()
    plt.savefig(filename)
    plt.close()


# keep the reference's entry-point name for familiarity
def plot_node_coverages(node_coverages, filename):
    return estimate_min_path_coverage(node_coverages, filename)


def _lazy_node_read_pairs(graph):
    """Unique (node_run, read_index) incidence pairs of a LAZY build, plus
    the per-read gene counts — the only inputs the k-selection statistics
    need (reference: per-node read lists, graph_utils.py:258-313)."""
    lz = graph.lazy_tables()
    inv, wlens = lz["inv"], lz["wlens"]
    n_entries = len(lz["entries"])
    occ_read = np.repeat(np.arange(n_entries, dtype=np.int64), wlens)
    pair_key = (inv.astype(np.uint64) << np.uint64(32)) | occ_read.astype(np.uint64)
    upairs = np.unique(pair_key)
    prun = (upairs >> np.uint64(32)).astype(np.int64)
    pread = (upairs & np.uint64(0xFFFFFFFF)).astype(np.int64)
    read_len = wlens.astype(np.int64) + (graph.get_kmerSize() - 1)
    return prun, pread, read_len


def _lazy_amr_node_mask(graph, sample_genesOfInterest) -> np.ndarray:
    """Boolean per-unique-node 'contains an AMR gene' vector computed from
    the occurrence stream (every window of a node shares the canonical
    gene multiset, so per-occurrence window membership OR-reduced onto the
    node table equals the object path's per-node token scan)."""
    lz = graph.lazy_tables()
    n_nodes = len(lz["uh"])
    vocab = graph.vocab
    gids = {vocab.id_of(g) for g in sample_genesOfInterest if g in vocab}
    if not gids or n_nodes == 0:
        return np.zeros(n_nodes, dtype=bool)
    k = graph.get_kmerSize()
    entries, wlens = lz["entries"], lz["wlens"]
    toks = [e.tok for e in entries]
    flat = np.concatenate(toks) if toks else np.zeros(0, np.int32)
    tlens = np.fromiter((len(t) for t in toks), np.int64, len(toks))
    toff = np.concatenate([[0], np.cumsum(tlens)])
    amr_tok = np.isin(np.abs(flat), np.fromiter(gids, np.int64, len(gids)))
    c = np.concatenate([[0], np.cumsum(amr_tok)])
    occ_entry = np.repeat(np.arange(len(entries), dtype=np.int64), wlens)
    occ_wi = np.arange(len(occ_entry), dtype=np.int64) - lz["offs"][:-1][occ_entry]
    start = toff[occ_entry] + occ_wi
    occ_amr = (c[start + k] - c[start]) > 0
    node_amr = np.zeros(n_nodes, dtype=bool)
    np.logical_or.at(node_amr, lz["inv"][occ_amr], True)
    return node_amr


def _lazy_component_labels(graph) -> np.ndarray:
    """Connected-component labels over the unique-node table."""
    lz = graph.lazy_tables()
    n = len(lz["uh"])
    edges = graph._edge_table()
    src_idx, tgt_idx = edges[7], edges[8]
    return clean._components(n, src_idx, tgt_idx)


def choose_kmer_size(
    overall_mean_node_coverage,
    new_annotatedReads,
    cores,
    new_gene_position_dict,
    sample_genesOfInterest,
    vocab=None,
    cache=None,
    device=None,
):
    """Largest odd k in [3, 15] such that every component keeps >= 80% of its
    AMR reads with >= 2k-1 genes (amira/graph_utils.py:258-296); k=3 when
    mean coverage < 20.

    Lazy builds answer the per-component statistic straight from the
    aggregation tables (incidence pairs + component labels) without
    materializing Node/Edge objects; parity with the object walk is pinned
    by tests/test_graph_utils.py."""
    geneMer_size = 3
    if overall_mean_node_coverage >= 20:
        for k in range(3, 16, 2):
            graph = build_graph(
                dict(new_annotatedReads), k, dict(new_gene_position_dict), vocab, cache, device
            )
            if graph.is_lazy:
                if _all_components_valid_lazy(graph, sample_genesOfInterest, k):
                    geneMer_size = k
                else:
                    break
                continue
            amr_nodes = {
                n.hash
                for g in sample_genesOfInterest
                for n in graph.get_nodes_containing(g)
            }

            def is_component_valid(component):
                nodes_in_component = [
                    n.hash for n in graph.get_nodes_in_component(component)
                ]
                reads = graph.collect_reads_in_path(
                    [n for n in nodes_in_component if n in amr_nodes]
                )
                lengths = [len(graph.get_reads()[r]) for r in reads]
                if len(lengths) != 0:
                    return (
                        len([x for x in lengths if x >= (2 * k - 1)]) / len(lengths)
                        >= 0.8
                    )
                return True

            if all(is_component_valid(c) for c in graph.components()):
                geneMer_size = k
            else:
                break
    return geneMer_size


def _all_components_valid_lazy(graph, sample_genesOfInterest, k) -> bool:
    """Table-backed 'every component keeps >=80% of its AMR reads at
    >=2k-1 genes' check (the is_component_valid quantifier over
    graph.components() of the object path)."""
    lz = graph.lazy_tables()
    if len(lz["uh"]) == 0:
        return True
    node_amr = _lazy_amr_node_mask(graph, sample_genesOfInterest)
    if not node_amr.any():
        return True
    comp = _lazy_component_labels(graph)
    prun, pread, read_len = _lazy_node_read_pairs(graph)
    on_amr = node_amr[prun]
    if not on_amr.any():
        return True
    # unique (component, read) pairs among AMR-node incidences
    ckey = comp[prun[on_amr]].astype(np.uint64) << np.uint64(32)
    ckey |= pread[on_amr].astype(np.uint64)
    ukey = np.unique(ckey)
    ucomp = (ukey >> np.uint64(32)).astype(np.int64)
    uread = (ukey & np.uint64(0xFFFFFFFF)).astype(np.int64)
    qualified = read_len[uread] >= (2 * k - 1)
    n_comp = int(comp.max()) + 1
    totals = np.bincount(ucomp, minlength=n_comp)
    good = np.bincount(ucomp[qualified], minlength=n_comp)
    with np.errstate(invalid="ignore", divide="ignore"):
        frac = np.where(totals > 0, good / np.maximum(totals, 1), 1.0)
    return bool((frac >= 0.8).all())


def get_overall_mean_node_coverages(graph):
    """Per-k mean of 'reads on node with >= k genes' counts
    (amira/graph_utils.py:299-313). Lazy builds compute the statistic from
    the unique incidence pairs; object builds keep the reference walk."""
    if graph.is_lazy:
        lz = graph.lazy_tables()
        n_nodes = len(lz["uh"])
        out = {}
        if n_nodes == 0:
            return {k: 0 for k in range(3, 16, 2)}
        _prun, pread, read_len = _lazy_node_read_pairs(graph)
        plen = read_len[pread]
        for k in range(3, 16, 2):
            out[k] = float(np.sum(plen >= k) / n_nodes)
        return out
    reads = graph.get_reads()
    read_len = {r: len(reads[r]) for r in reads}
    out = {}
    node_read_lists = [n.reads for n in graph.all_nodes()]
    for k in range(3, 16, 2):
        coverages = [
            sum(1 for r in node_reads if read_len[r] >= k)
            for node_reads in node_read_lists
        ]
        out[k] = float(np.mean(coverages)) if coverages else 0
    return out
