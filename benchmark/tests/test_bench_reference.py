"""The reference against the program, through the harness's own run of a
cell, on a tiny isolate: on the CPU (`--device cpu`; the harness's look for
a chip is skipped) and, marked `cuda`, on the card. A sound run is
correct; each fault of `faults.py` that the cell can have, planted under
the timed path, makes `correct` false."""

from __future__ import annotations

import pytest

from conftest import tiny

import run

CASES = [
    ("ecoli_calls.noisy50k", None, True),
    ("ecoli_calls.noisy50k", "polish_unchanged", False),  # the control
    ("ecoli_calls.noisy50k", "copy_number_doubled", False),
    ("ecoli_calls.noisy50k", "closest_reference_swapped", False),
    ("ecoli_calls.noisy50k", "row_dropped", False),
    ("ecoli_calls.noisy50k", "row_duplicated", False),
    ("ecoli_calls.noisy50k", "half_jobs", False),
    ("ecoli_calls.noisy50k", "cleaning_skipped", False),
    ("ecoli_calls.noisy50k", "writes_dropped", False),
    ("ecoli_sam.noisy10k", None, True),
    ("ecoli_sam.noisy10k", "half_jobs", False),
    ("ecoli_sam.noisy10k", "qc_unaligned", False),
]


def _check(cell, fault, expected, device):
    result, _lines = run.run_cell(cell, 2**31 + 99, 0, device=device, overrides=tiny(cell), fault=fault)
    assert result["attempted"] == 1
    assert result["correct"] is expected, result["checks"]
    assert list(result)[-1] == "checks"
    assert run.loaded_forbidden() == []
    return result


@pytest.mark.parametrize("cell,fault,expected", CASES)
def test_cpu(work, cell, fault, expected):
    result = _check(cell, fault, expected, "cpu")
    assert set(result["metrics"]) == {"reads_per_s", "setup_s"}


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault,expected", CASES)
def test_card(work, cuda_device, cell, fault, expected):
    result = _check(cell, fault, expected, cuda_device)
    assert result["device"]["platform"] == "gpu"
