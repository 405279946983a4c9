"""The port's --debug and --output-component-fastqs outputs
(`python -m amira_tpu_torch --device cpu`) against the JAX package's CLI,
on the seed-33 isolate of tests/test_modes.py: the same files, each equal
(GML graphs, unitig lists, the mid-correction and corrected gene-call
JSONs, reads_per_amr_gene.json, the allele FASTAs, amira_results.tsv with
its "Longest read length" and "Component ID" columns; gzip FASTQs
compared decompressed, plots only by name).

Tolerance: zero; files byte for byte.
"""

import gzip
import os

import pytest
import torch

from chip_smoke import mode_argv

SKIP = {"phase_timings.json"}  # wall-clock times


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain SW versions run many small torch ops: one intra-op thread
    is as fast here, and keeps parallel test workers off each other's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv):
    try:
        main(argv)
    except SystemExit as e:
        assert e.code in (None, 0)


def _files(root):
    return sorted(
        os.path.relpath(os.path.join(d, f), root)
        for d, _dirs, names in os.walk(root)
        for f in names
    )


def _content(path):
    if path.endswith(".png"):
        return None
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


def test_debug_and_component_outputs_match_jax(tmp_path):
    from amira_tpu.__main__ import main as jax_main
    from amira_tpu_torch.__main__ import main as port_main

    argv = mode_argv("debug", str(tmp_path))
    _run(jax_main, argv + ["--output", str(tmp_path / "jax")])
    _run(port_main, argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    jax_files = _files(tmp_path / "jax")
    assert _files(tmp_path / "port") == jax_files
    for name in ("gene_mer_graph.3.3.1.gml", "pre_correction_gene_mer_graph.3.1.1.gml",
                 "mid_correction_gene_calls.json", "reads_per_amr_gene.json",
                 os.path.join("component_fastqs", "1.fastq.gz")):
        assert name in jax_files, name
    for name in jax_files:
        if name not in SKIP:
            assert _content(str(tmp_path / "port" / name)) == _content(
                str(tmp_path / "jax" / name)
            ), name
    header = _content(str(tmp_path / "port" / "amira_results.tsv")).split(b"\n")[0]
    assert b"Longest read length" in header and b"Component ID" in header
