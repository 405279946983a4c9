"""The port's modes (`python -m amira_tpu_torch --device cpu`) against the
JAX package's CLI on the small isolates of tests/test_modes.py and
tests/test_promoters.py (built by `chip_smoke.mode_argv`):

* --assembly: an assembly FASTA as input (k = 3, no junk-read removal or
  cleaning, "N/A" copy numbers);
* --meta: no junk-read removal, "N/A" copy numbers;
* --promoter-mutations: an amrX promoter reference one SNP away from the
  reads, reported as a promoter row (the rows appended to the result table
  as `pd.concat` appends them).

Each writes amira_results.tsv byte for byte as the JAX package does; both
are held to the committed goldens (tests/goldens/amira_results_<mode>_
seed<N>.tsv, written by amira_tpu), which chip_smoke.py holds the card to.

Tolerance: zero; files byte for byte.
"""

import os

import pytest
import torch

from chip_smoke import MODE_GOLDENS, mode_argv

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


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


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize("mode", ["assembly", "meta", "promoters"])
def test_mode_tsv_matches_jax_and_golden(mode, tmp_path):
    from amira_tpu.__main__ import main as jax_main
    from amira_tpu_torch.__main__ import main as port_main

    argv = mode_argv(mode, str(tmp_path))
    _run(jax_main, argv + ["--output", str(tmp_path / "jax")])
    _run(port_main, argv + ["--output", str(tmp_path / "port"), "--device", "cpu"])
    golden = _read(os.path.join(GOLDENS, MODE_GOLDENS[mode]))
    assert _read(tmp_path / "jax" / "amira_results.tsv") == golden
    assert _read(tmp_path / "port" / "amira_results.tsv") == golden
    if mode == "promoters":
        assert "amrX_promoter_A51C" in golden
    else:
        assert "\tN/A\tN/A\t" in golden
