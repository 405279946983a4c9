"""The benchmark's own tests (run by hand: `python -m pytest benchmark/tests`;
the repository's `tests/` suite does not collect them). Imports no JAX."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
for _p in (str(BENCH), str(BENCH.parent)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

# genomes and isolates small enough for the CPU, amrX at two loci and amrY
# at one, no warm-up: for the JSON route 40 genes and 300 reads of 3-6 genes
# (~30x); for the SAM route, whose QC aligns every read to every gene with
# the plain SW version, 20 genes of 300 bp and 200 reads of 3-5 (~35x)
TINY = {
    "genes": 40,
    "amr_after": {"amrX": [5, 25], "amrY": [15]},
    "reads": 300,
    "genes_per_read": [3, 6],
    "warmup": [],
}
TINY_SAM = {
    "genes": 20,
    "gene_len": 300,
    "amr_after": {"amrX": [3, 15], "amrY": [10]},
    "reads": 200,
    "genes_per_read": [3, 5],
    "warmup": [],
}


def tiny(cell: str) -> dict:
    return TINY_SAM if cell.startswith("ecoli_sam") else TINY


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips inside the test when none is visible"
    )


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device is visible")
    return "cuda"


@pytest.fixture
def work(tmp_path, monkeypatch):
    """The harness's work directory under the test's own temporary one."""
    import run

    monkeypatch.setattr(run, "WORK", tmp_path / "bench_work")
    return tmp_path
