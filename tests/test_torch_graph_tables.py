"""The port's build without a cache against the JAX package's.

* Tables: the port's `flat_occurrences` -> `assemble_node_tables` /
  `assemble_edge_tables` (torch, CPU tensors here) against JAX's
  `bucket_occurrences` over its length buckets -> `assemble_*` ->
  `compact_*`, at k = 3, 5 and 7: the compact node (hash, first order key,
  coverage), (node, read) pair and edge (key, coverage, first order key)
  tables are equal, among them gene hashes >= 2^62 and node and edge
  hashes >= 2^63 (negative as int64). The port's assembly of JAX's own
  bucket streams, padding slots (UINT_MAX, BIGKEY) included, gives the same
  tables, and its flat streams hold JAX's valid slots.
* Callers: `build_and_correct_graph(cache=None)` and
  `iterative_bubble_popping(cache=None)` on `make_isolate` isolates, in
  both packages, give the same corrected calls, positions, short reads and
  chosen k; every graph they build is eager (`is_lazy` False) on both
  sides, so both take the object cleaning branch.

Tolerance: zero; hashes, keys and counts are integers.
"""

import copy
import json

import numpy as np
import pytest
import torch

from amira_tpu import graph as jax_graph_mod
from amira_tpu import graph_utils as jax_graph_utils
from amira_tpu import pipeline as jax_pipeline
from amira_tpu.ops import graph_tables as jax_tables
from amira_tpu.vocab import GeneVocab as JaxVocab
from amira_tpu.vocab import pack_reads as jax_pack_reads
from amira_tpu_torch import graph_utils as port_graph_utils
from amira_tpu_torch import pipeline as port_pipeline
from amira_tpu_torch.ops import graph_tables
from amira_tpu_torch.ops.hashing import gene_hash
from amira_tpu_torch.vocab import GeneVocab as PortVocab
from synthetic import make_isolate


def _reads(seed, n_reads=150, n_genes=40):
    """Random stranded gene calls, 1-14 genes a read (short reads among
    them), some read from the other strand, some with a miscalled gene."""
    rng = np.random.RandomState(seed)
    genome = [f"g{i}" for i in range(n_genes)]
    calls = {}
    for r in range(n_reads):
        L = rng.randint(1, 15)
        s = rng.randint(0, n_genes - L + 1)
        genes = [("+" if rng.rand() < 0.8 else "-") + g for g in genome[s : s + L]]
        if rng.rand() < 0.3:
            genes = [("-" if g[0] == "+" else "+") + g[1:] for g in reversed(genes)]
        if rng.rand() < 0.2 and L > 2:
            genes[rng.randint(0, L)] = f"+err{rng.randint(0, 6)}"
        calls[f"r{r}"] = genes
    return calls


def _kept_tokens(calls, k):
    tok = JaxVocab().encode_reads_batch(list(calls.values()))
    return [t for t in tok if len(t) >= k]


def _jax_streams(kept_tok, k):
    """JAX's uncached build's streams (amira_tpu/graph.py:_build): one
    bucket_occurrences launch per power-of-two length bucket, rows padded
    to a power of two with sel = -1, streams concatenated."""
    kept_len = np.asarray([len(t) for t in kept_tok])
    order = np.argsort(kept_len, kind="stable")
    parts, i = [], 0
    while i < len(order):
        lb = jax_graph_mod._bucket(int(kept_len[order[i]]))
        j = i
        while j < len(order) and jax_graph_mod._bucket(int(kept_len[order[j]])) == lb:
            j += 1
        sel = order[i:j]
        i = j
        tokens, lengths = jax_pack_reads([kept_tok[s] for s in sel], pad_to=lb)
        n_pad = jax_graph_mod._bucket(len(sel)) - len(sel)
        tokens = np.vstack([tokens, np.zeros((n_pad, lb), np.int32)])
        lengths = np.concatenate([lengths, np.zeros(n_pad, np.int32)])
        sel_arr = np.full(len(sel) + n_pad, -1, np.int32)
        sel_arr[: len(sel)] = sel
        parts.append([np.asarray(x) for x in jax_tables.bucket_occurrences(tokens, lengths, sel_arr, k)])
    return [np.concatenate([p[c] for p in parts]) for c in range(6)]


def _jax_compact_tables(streams, n_reads):
    occ_hash, _occ_dir, occ_read, occ_key, ekeys, eokey = streams
    sh, boundary, run_key, run_cov, pboundary, pair_run, pair_read = (
        jax_tables.assemble_node_tables(occ_hash, occ_read, occ_key, n_reads)
    )
    esk, eboundary, ecov, eokey_s = jax_tables.assemble_edge_tables(ekeys, eokey)
    n_nodes, n_pairs, n_edges = (
        int(x) for x in np.asarray(jax_tables.count_true3(boundary, pboundary, eboundary))
    )
    join = jax_tables.join_u64
    nt = [np.asarray(x) for x in jax_tables.compact_node_tables(sh, boundary, run_key, run_cov, n_nodes)]
    pt = [np.asarray(x) for x in jax_tables.compact_pair_tables(pboundary, pair_run, pair_read, n_pairs)]
    et = [np.asarray(x) for x in jax_tables.compact_edge_tables(esk, eboundary, ecov, eokey_s, max(n_edges, 1))]
    return {
        "node_hash": join(nt[0], nt[1]),
        "node_key": join(nt[2], nt[3]).astype(np.int64),
        "node_cov": nt[4].astype(np.int64),
        "pair_run": pt[0].astype(np.int64),
        "pair_read": pt[1].astype(np.int64),
        "edge_key": join(et[0], et[1])[:n_edges],
        "edge_cov": et[2][:n_edges].astype(np.int64),
        "edge_okey": join(et[3], et[4])[:n_edges].astype(np.int64),
    }


def _port_tables(occ_hash, occ_read, occ_key, ekeys, eokey):
    node = [t.numpy() for t in graph_tables.assemble_node_tables(occ_hash, occ_read, occ_key)]
    edge = [t.numpy() for t in graph_tables.assemble_edge_tables(ekeys, eokey)]
    return {
        "node_hash": node[0].view(np.uint64),
        "node_key": node[1],
        "node_cov": node[2],
        "pair_run": node[3],
        "pair_read": node[4],
        "edge_key": edge[0].view(np.uint64),
        "edge_cov": edge[1],
        "edge_okey": edge[2],
    }


def _assert_tables_equal(got, ref):
    assert list(got) == list(ref)
    for name in ref:
        assert got[name].dtype == ref[name].dtype, name
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)


def _as_torch(x):
    """A JAX stream as a torch int64 tensor (uint64 hashes as bit patterns)."""
    x = np.asarray(x)
    return torch.from_numpy(x.view(np.int64) if x.dtype == np.uint64 else x.astype(np.int64))


@pytest.mark.parametrize("k", [3, 5, 7])
def test_compact_tables_match_jax(k):
    calls = _reads(k)
    kept = _kept_tokens(calls, k)
    streams = _jax_streams(kept, k)
    ref = _jax_compact_tables(streams, len(kept))

    lens = torch.tensor([len(t) for t in kept], dtype=torch.int64)
    flat = torch.from_numpy(np.concatenate(kept))
    occ_hash, occ_dir, occ_read, occ_key, ekeys, eokey = graph_tables.flat_occurrences(flat, lens, k)
    got = _port_tables(occ_hash, occ_read, occ_key, ekeys, eokey)
    _assert_tables_equal(got, ref)

    # the hashes span the whole unsigned range: gene hashes >= 2^62, node
    # and edge hashes >= 2^63 (negative as int64) and below it
    genes = gene_hash(flat).abs()
    assert bool((genes >= 1 << 62).any()) and bool((genes < 1 << 62).any())
    for name in ("node_hash", "edge_key"):
        assert (ref[name] >= np.uint64(1 << 63)).any() and (ref[name] < np.uint64(1 << 63)).any()

    # the flat streams hold exactly JAX's valid slots
    occ_h, occ_d, occ_r, occ_k, ek, eok = streams
    valid = occ_h != jax_tables.UINT_MAX
    o = np.argsort(occ_k[valid])
    np.testing.assert_array_equal(occ_key.numpy(), occ_k[valid][o])
    np.testing.assert_array_equal(occ_hash.numpy().view(np.uint64), occ_h[valid][o])
    np.testing.assert_array_equal(occ_dir.numpy(), occ_d[valid][o])
    np.testing.assert_array_equal(occ_read.numpy(), occ_r[valid][o])
    evalid = ek != jax_tables.UINT_MAX
    o = np.argsort(eok[evalid])
    np.testing.assert_array_equal(np.sort(eokey.numpy()), eok[evalid][o])
    np.testing.assert_array_equal(ekeys.numpy().view(np.uint64)[np.argsort(eokey.numpy())], ek[evalid][o])


@pytest.mark.parametrize("k", [3, 5, 7])
def test_assembly_of_padded_jax_streams(k):
    """JAX's bucket streams, padding slots and all, through the port's
    assembly: the sentinels sort last and drop out."""
    kept = _kept_tokens(_reads(20 + k), k)
    streams = _jax_streams(kept, k)
    occ_h, _d, occ_r, occ_k, ek, eok = streams
    assert (occ_h == jax_tables.UINT_MAX).any() and (occ_k == 2**62).any()
    assert (ek == jax_tables.UINT_MAX).any() and (eok == 2**62).any()
    got = _port_tables(*(_as_torch(x) for x in (occ_h, occ_r, occ_k, ek, eok)))
    _assert_tables_equal(got, _jax_compact_tables(streams, len(kept)))


def _isolate_inputs(tmp_path, **iso):
    """What run_pipeline hands the cleaning loop, from each package's own
    ingest: gene calls, positions, FASTQ content, the genes of interest,
    the per-k mean node coverages of the initial graph and its coverage
    trough; identical on both sides."""
    from amira_tpu_torch.io import parse_fastq
    from amira_tpu_torch.preprocess import (
        load_species_specific_files,
        process_pandora_json,
        process_reference_alleles,
    )

    files = make_isolate(str(tmp_path / "iso"), **iso)
    fasta, _, _, _ = load_species_specific_files(
        "Escherichia_coli", files["amr_fasta"], files["amr_calls"], files["core_genes"],
        files["plasmid_genes"],
    )
    _, genes_of_interest = process_reference_alleles(fasta, False)
    reads, sample_goi, positions = process_pandora_json(
        files["calls"], genes_of_interest, files["positions"]
    )
    reads = dict(sorted(reads.items()))
    graph = port_graph_utils.build_graph(reads, 3, positions, PortVocab(), device="cpu")
    coverages = port_graph_utils.get_overall_mean_node_coverages(graph)
    try:
        min_path_coverage = port_graph_utils.estimate_min_path_coverage(graph.get_all_node_coverages())
    except (ValueError, IndexError):
        min_path_coverage = 10
    return reads, positions, parse_fastq(files["fastq"]), sample_goi, coverages, min_path_coverage


def _record_laziness(monkeypatch):
    """Every graph the callers build, on either side, records is_lazy."""
    seen = {"jax": [], "port": []}
    for side, mod in (("jax", jax_graph_utils), ("port", port_graph_utils)):
        real = mod.build_graph

        def recording(*args, _real=real, _side=side, **kwargs):
            g = _real(*args, **kwargs)
            seen[_side].append(g.is_lazy)
            return g

        monkeypatch.setattr(mod, "build_graph", recording)
    monkeypatch.setattr(jax_pipeline, "build_graph", jax_graph_utils.build_graph)
    monkeypatch.setattr(port_pipeline, "build_graph", port_graph_utils.build_graph)
    return seen


ISOLATES = {
    "seed7": dict(
        seed=7, n_reads=90, amr_genes=("amrX", "amrY"),
        layout=["geneA", "geneB", "amrX", "geneC", "geneD", "amrY", "geneE", "geneF"],
    ),
    # miscalled genes for the cleaning to correct, and reads long enough
    # for choose_kmer_size to take k = 5
    "noisy": dict(
        seed=5, n_reads=200, genes_per_read=(8, 14), call_noise=0.05,
        layout=[f"gene{c}" for c in "ABCDEFGH"] + ["amrX"] + [f"gene{c}" for c in "IJKLMNOP"],
    ),
}


@pytest.mark.parametrize("isolate", list(ISOLATES))
def test_build_and_correct_graph_without_cache(isolate, tmp_path, monkeypatch):
    reads, positions, fastq, goi, coverages, min_cov = _isolate_inputs(tmp_path, **ISOLATES[isolate])
    seen = _record_laziness(monkeypatch)
    out = {}
    for side, pipe, vocab in (("jax", jax_pipeline, JaxVocab()), ("port", port_pipeline, PortVocab())):
        short_reads, short_pos = {}, {}
        kwargs = {"device": "cpu"} if side == "port" else {}
        result = pipe.build_and_correct_graph(
            copy.deepcopy(reads), copy.deepcopy(positions), 3, fastq, str(tmp_path / side),
            False, dict(coverages), 1, short_reads, short_pos, set(goi), min_cov, True,
            vocab, None, **kwargs,
        )
        out[side] = (result, short_reads, short_pos)
    assert out["port"] == out["jax"]
    assert seen["port"] and seen["port"] == seen["jax"]
    assert not any(seen["port"])
    if isolate == "noisy":
        assert out["port"][0][2] == 5  # the chosen k
        assert out["port"][0][0] != reads  # the calls were corrected


@pytest.mark.parametrize("k", [3, 5])
def test_iterative_bubble_popping_without_cache(k, tmp_path, monkeypatch):
    reads, positions, fastq, goi, _coverages, min_cov = _isolate_inputs(tmp_path, **ISOLATES["noisy"])
    seen = _record_laziness(monkeypatch)
    out = {}
    for side, utils, vocab in (("jax", jax_graph_utils, JaxVocab()), ("port", port_graph_utils, PortVocab())):
        short_reads, short_pos = {}, {}
        kwargs = {"device": "cpu"} if side == "port" else {}
        result = utils.iterative_bubble_popping(
            copy.deepcopy(reads), copy.deepcopy(positions), 30, k, 1, short_reads, short_pos,
            fastq, str(tmp_path / side), 3, set(goi), min_cov, vocab, True, None, **kwargs,
        )
        out[side] = (json.dumps(result, sort_keys=True), short_reads, short_pos)
    assert out["port"] == out["jax"]
    assert seen["port"] and seen["port"] == seen["jax"]
    assert not any(seen["port"])
