"""The port's path assembly (`amira_tpu_torch.assembly`) against the JAX
package's on the fixtures of tests/test_assembly_olc.py: `assemble_reads`
gives the same contigs with the same members, in order (the greedy OLC
layout and repeat walk on the host, then the polish by the banded SW at the
band the fixture asks for: 256, or the default 512 that
`assemble_full_length_paths` uses), and `assemble_path` writes the same
FASTA. `assemble_full_length_paths` logs and skips a path whose assembly
raises, as the JAX package does.

The JAX package runs its XLA engine; the port its plain SW version on the
CPU (its kernels on a card are held to that version elsewhere).

Tolerance: zero; contig strings and member lists with ==, files byte for
byte.
"""

import gzip
import os

import numpy as np
import pytest
import torch

from amira_tpu import assembly as jax_assembly
from amira_tpu_torch import assembly as port_assembly
from test_assembly_olc import _genome, _tile_reads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain SW versions run many small torch ops: one intra-op thread
    is as fast here, and keeps parallel test workers off each other's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _past_longest_read():
    rng = np.random.RandomState(7)
    return _tile_reads(rng, _genome(rng, 3000), read_len=700, step=250), dict(
        polish_iterations=2, band_width=256
    )


def _noisy():
    rng = np.random.RandomState(3)
    return _tile_reads(rng, _genome(rng, 1500), read_len=800, step=200, sub=0.01), dict(
        polish_iterations=2, band_width=512
    )


def _two_components():
    rng = np.random.RandomState(11)
    t1, t2 = _genome(rng, 1500), _genome(rng, 1200)
    reads = _tile_reads(rng, t1, read_len=600, step=300)
    reads.update({f"s{k}": v for k, v in _tile_reads(rng, t2, 500, 250).items()})
    return reads, dict(polish_iterations=1, band_width=512)


def _tandem_duplication():
    rng = np.random.RandomState(11)
    u1, r, u2 = _genome(rng, 700), _genome(rng, 900), _genome(rng, 700)
    return _tile_reads(rng, u1 + r + r + u2, read_len=400, step=70, rc_fraction=0.0), dict(
        min_votes=5, polish_iterations=1
    )


def _interspersed_mixed_strand():
    rng = np.random.RandomState(3)
    a, r, b, c = (_genome(rng, n) for n in (300, 450, 300, 300))
    return _tile_reads(rng, a + r + b + r + c, read_len=650, step=80, rc_fraction=0.5), dict(
        min_votes=5, polish_iterations=1
    )


FIXTURES = {
    "past_longest_read": _past_longest_read,
    "noisy_w512": _noisy,
    "two_components_w512": _two_components,
    "tandem_duplication_w512": _tandem_duplication,
    "interspersed_mixed_strand_w512": _interspersed_mixed_strand,
}


@pytest.fixture(autouse=True)
def _xla_engine(monkeypatch):
    monkeypatch.setenv("AMIRA_TPU_SW_ENGINE", "xla")


@pytest.mark.parametrize("name", list(FIXTURES))
def test_assemble_reads_matches_jax(name):
    reads, kwargs = FIXTURES[name]()
    ref = jax_assembly.assemble_reads(dict(reads), **kwargs)
    got = port_assembly.assemble_reads(dict(reads), **kwargs, device="cpu")
    assert ref, name
    assert got == ref


def _write_fastq(path, reads):
    with gzip.open(path, "wt") as o:
        for rid, seq in reads.items():
            o.write(f"@{rid}\n{seq}\n+\n{'I' * len(seq)}\n")


def test_assemble_path_writes_the_same_fasta(tmp_path):
    rng = np.random.RandomState(5)
    reads = _tile_reads(rng, _genome(rng, 1400), read_len=600, step=250)
    fq = str(tmp_path / "reads.fastq.gz")
    _write_fastq(fq, reads)
    # the default band, 512, as assemble_full_length_paths polishes
    ref = jax_assembly.assemble_path(fq, str(tmp_path / "jax"), iterations=1)
    got = port_assembly.assemble_path(fq, str(tmp_path / "port"), iterations=1, device="cpu")
    with open(ref) as f, open(got) as g:
        text = g.read()
        assert text == f.read()
    assert text.startswith(">contig_1")


def test_full_length_paths_log_and_skip_a_failing_path(tmp_path, monkeypatch, capsys):
    rng = np.random.RandomState(8)
    path_dir = tmp_path / "AMR_allele_fastqs" / "path_reads"
    path_dir.mkdir(parents=True)
    _write_fastq(str(path_dir / "1.fastq.gz"), _tile_reads(rng, _genome(rng, 900), 500, 200))
    _write_fastq(str(path_dir / "2.fastq.gz"), {"bad": "ACGT" * 40})

    def assemble(fastq_path, out_dir, *args, device, **kwargs):
        if fastq_path.endswith("2.fastq.gz"):
            raise RuntimeError("sw_dp launch failed: CUDA error 1")
        return real(fastq_path, out_dir, *args, iterations=1, device=device, **kwargs)

    real = port_assembly.assemble_path
    monkeypatch.setattr(port_assembly, "assemble_path", assemble)
    port_assembly.assemble_full_length_paths(str(tmp_path), device="cpu")
    assert os.path.exists(tmp_path / "path_assemblies" / "path_1" / "assembly.fasta")
    assert not os.path.exists(tmp_path / "path_assemblies" / "path_2")
    assert "error assembling path 2: sw_dp launch failed" in capsys.readouterr().err
