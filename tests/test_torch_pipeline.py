"""End to end through the port's CLI (`python -m amira_tpu_torch --device
cpu`): the seed-7 isolate reproduces tests/goldens/amira_results_seed7.tsv
byte for byte, and on the single-copy, two-copy and no-AMR isolates of
tests/test_pipeline.py the port writes the same amira_results.tsv and
corrected_gene_calls.json as the JAX package's CLI. The pandas-free result
table writes the TSV that `DataFrame.to_csv(sep="\\t", index=False)` writes.

Tolerance: zero; files are compared byte for byte.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from amira_tpu_torch.results import ResultTable
from synthetic import make_isolate

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "amira_results_seed7.tsv")

ISOLATES = {
    "single_copy": dict(seed=0, n_reads=80),
    "no_amr": dict(
        seed=1, n_reads=30, layout=["geneA", "geneB", "geneC", "geneD"],
        amr_genes=("amrZ",),
    ),
    "two_copy": dict(
        seed=2, n_reads=160, genes_per_read=(4, 7),
        layout=[
            "geneA", "geneB", "amrX", "geneC", "geneD", "geneE", "geneF",
            "geneG", "geneK", "geneL", "amrX", "geneH", "geneI", "geneJ",
        ],
    ),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain SW versions run many small torch ops: one intra-op thread
    is as fast here, and keeps parallel test workers off each other's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _run_port(files, outdir):
    from amira_tpu_torch.__main__ import main

    _run(main, _argv(files, outdir) + ["--device", "cpu"])
    return outdir


def _read(path):
    with open(path) as f:
        return f.read()


def test_port_reproduces_committed_golden(tmp_path):
    files = make_isolate(
        str(tmp_path / "data"), seed=7, n_reads=90, amr_genes=("amrX", "amrY"),
        layout=["geneA", "geneB", "amrX", "geneC", "geneD", "amrY", "geneE", "geneF"],
    )
    out = _run_port(files, str(tmp_path / "out"))
    assert _read(os.path.join(out, "amira_results.tsv")) == _read(GOLDEN)
    timings = _read(os.path.join(out, "phase_timings.json"))
    for name in ("initial_graph_build", "allele_polishing", "copy_number_estimation"):
        assert f'"{name}"' in timings
    assert os.path.exists(
        os.path.join(out, "AMR_allele_fastqs", "amrX_1", "06.final_sequence.fasta")
    )
    assert any(f.endswith(".gml") for f in os.listdir(out))


@pytest.mark.parametrize("name", sorted(ISOLATES))
def test_port_matches_jax_cli(name, tmp_path):
    from amira_tpu.__main__ import main as jax_main

    files = make_isolate(str(tmp_path / "data"), **ISOLATES[name])
    ref = str(tmp_path / "jax")
    _run(jax_main, _argv(files, ref) + ["--no-dist-build"])
    got = _run_port(files, str(tmp_path / "port"))
    outputs = ["amira_results.tsv"]
    if name != "no_amr":  # the no-AMR run stops before the graph
        outputs.append("corrected_gene_calls.json")
    for fn in outputs:
        assert _read(os.path.join(got, fn)) == _read(os.path.join(ref, fn)), fn


def _random_rows(rng, n):
    names = ["amrX", "amrY", "blaTEM", "", "aac(3)/aph"]
    rows = []
    for i in range(n):
        tie = rng.rand() < 0.3
        rows.append({
            "Determinant name": names[rng.randint(len(names))],
            "Sequence name": "phen, with \"quotes\"" if rng.rand() < 0.1 else "phen",
            "Closest reference": f"NG{rng.randint(1000):03d}",
            "Reference length": f"{rng.randint(900)}/{rng.randint(900)}" if tie else int(rng.randint(900)),
            "Identity (%)": 0 if rng.rand() < 0.1 else round(float(rng.rand()) * 100, 1),
            "Coverage (%)": min(100.0, round(float(rng.rand()) * 110, 1)),
            "Cigar string": f"{rng.randint(500)}=",
            "Amira allele": f"amr_{i}",
            "Number of reads used for polishing": int(rng.randint(100)),
        })
    return rows


@pytest.mark.parametrize("n", [1, 5, 40])
def test_result_table_tsv_equals_pandas(n, tmp_path):
    """Column dtypes (int, float with an int 0, mixed str/int), quoting, the
    sort of tied names over more than 16 rows, columns added later, and a
    row filter that keeps a float column's dtype."""
    rng = np.random.RandomState(n)
    rows = _random_rows(rng, n)
    depth = [float(rng.rand()) for _ in range(n)]
    keep = [bool(rng.rand() < 0.7) for _ in range(n)]
    comments = ["Partially present gene." if i % 3 else "" for i in range(sum(keep))]

    df = pd.DataFrame(rows)
    table = ResultTable(rows)
    df["Relative mean read depth"] = depth
    df["Approximate cellular copy number"] = [d * 2 for d in depth]
    table.set_column("Relative mean read depth", depth)
    table.set_column("Approximate cellular copy number", [d * 2 for d in depth])
    df = df[np.asarray(keep, dtype=bool)].copy()
    df["Comments"] = comments
    table = table.select(keep)
    table.set_column("Comments", comments)
    df.sort_values(by="Determinant name").to_csv(
        tmp_path / "pandas.tsv", sep="\t", index=False
    )
    table.sort_by("Determinant name").write_tsv(tmp_path / "port.tsv")
    assert _read(tmp_path / "port.tsv") == _read(tmp_path / "pandas.tsv")
