"""The port's pandora-SAM route (`python -m amira_tpu_torch --pandoraSam
... --pandoraConsensus ... --device cpu`) against the JAX package's, on the
synthetic pseudo-SAM and consensus of tests/test_sam_ingestion.py: the same
amira_results.tsv and the same gene_calls/gene_positions_with_gene_filtering
JSONs, byte for byte; the consensus QC (`remove_poorly_mapped_genes`, which
aligns reads against every consensus gene) keeps the same genes with equal
per-base depth arrays; the read subsampling and the pandora-map error exits
behave as the JAX package's.

Tolerance: zero; files byte for byte, depth arrays element for element.
"""

import os

import numpy as np
import pytest
import torch

from amira_tpu import preprocess as jax_preprocess
from amira_tpu_torch import pipeline as port_pipeline
from amira_tpu_torch import preprocess as port_preprocess
from amira_tpu_torch.io import parse_fastq
from synthetic import make_isolate
from test_sam_ingestion import _write_consensus, _write_pandora_sam

OUTPUTS = (
    "amira_results.tsv",
    "gene_calls_with_gene_filtering.json",
    "gene_positions_with_gene_filtering.json",
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain SW versions run many small torch ops: one intra-op thread
    is as fast here, and keeps parallel test workers off each other's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sam_isolate(tmp_path_factory):
    d = tmp_path_factory.mktemp("sam")
    files = make_isolate(str(d / "data"), seed=41, n_reads=70)
    files["sam"] = str(d / "data" / "pandora.filtered.sam")
    files["consensus"] = str(d / "data" / "pandora.consensus.fq.gz")
    _write_pandora_sam(files, files["sam"])
    _write_consensus(files, files["consensus"])
    return files


def _argv(files, outdir, extra=()):
    return [
        "--pandoraSam", files["sam"],
        "--pandoraConsensus", files["consensus"],
        "--reads", files["fastq"],
        "--species", "Escherichia_coli",
        "--amr-fasta", files["amr_fasta"],
        "--amr-calls", files["amr_calls"],
        "--core-genes", files["core_genes"],
        "--plasmid-genes", files["plasmid_genes"],
        "--output", outdir,
        "--quiet",
        *extra,
    ]


def _run(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        assert e.code in (None, 0)


def _read(path):
    with open(path) as f:
        return f.read()


def test_sam_route_matches_jax(sam_isolate, tmp_path):
    from amira_tpu.__main__ import main as jax_main
    from amira_tpu_torch.__main__ import main as port_main

    _run(jax_main, _argv(sam_isolate, str(tmp_path / "jax")))
    _run(port_main, _argv(sam_isolate, str(tmp_path / "port"), ("--device", "cpu")))
    for name in OUTPUTS:
        assert _read(tmp_path / "port" / name) == _read(tmp_path / "jax" / name), name
    assert "amrX" in _read(tmp_path / "port" / "amira_results.tsv")


def test_consensus_qc_depths_match_jax(sam_isolate):
    # the QC's own sample of reads (its test hook), the same in both packages
    fastq = parse_fastq(sam_isolate["fastq"])
    jax_cons = parse_fastq(sam_isolate["consensus"])
    port_cons = parse_fastq(sam_isolate["consensus"])
    goi = {"amrX"}
    ref = jax_preprocess.remove_poorly_mapped_genes(jax_cons, 0.2, goi, fastq, max_reads=12)
    got = port_preprocess.remove_poorly_mapped_genes(
        port_cons, 0.2, goi, fastq, max_reads=12, device="cpu"
    )
    assert list(got) == list(ref) and list(port_cons) == list(jax_cons)
    for g in ref:
        np.testing.assert_array_equal(got[g], ref[g], err_msg=g)
    assert sum(int(d.sum()) for d in got.values()) > 0


@pytest.mark.parametrize("sample_size", [30, 500])
def test_subsampling_matches_jax(sam_isolate, sample_size):
    calls = {f"r{i}": ["+geneA", "-geneB", "+amrX"][: 1 + i % 3] for i in range(60)}
    depths = {"geneA": np.arange(5, dtype=np.int32), "geneB": np.ones(4, np.int32)}
    ref = jax_preprocess.subsample_reads_and_estimate_read_depth(
        calls, sample_size, sam_isolate["core_genes"], 9, depths
    )
    got = port_preprocess.subsample_reads_and_estimate_read_depth(
        calls, sample_size, sam_isolate["core_genes"], 9, depths
    )
    assert got == ref


@pytest.mark.parametrize("panrg", ["missing.panidx.zip", "exists.fa"])
def test_pandora_map_error_exits(tmp_path, panrg, capsys):
    path = str(tmp_path / panrg)
    if panrg == "exists.fa":
        open(path, "w").close()
    with pytest.raises(SystemExit) as e:
        port_pipeline.run_pandora_map(
            "pandora", path, "reads.fq", str(tmp_path), 1, 2025, None,
            "Escherichia_coli", False,
        )
    assert e.value.code == 1
    assert "panRG file" in capsys.readouterr().err
