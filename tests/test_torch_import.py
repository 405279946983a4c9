"""The PyTorch/CUDA port (`amira_tpu_torch`) stands alone: every module
imports with JAX and `amira_tpu` blocked, its copied constants equal the JAX
package's, the device choice is explicit, and the SW kernel wrappers use
their plain versions only for CPU tensors.

Tolerance: zero; every comparison is exact (integers and strings).
"""

import inspect
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import amira_tpu.ops.align as jax_align
import amira_tpu.ops.hashing as jax_hashing
import amira_tpu.ops.host_tables as jax_host_tables
import amira_tpu_torch
import amira_tpu_torch.native
import amira_tpu_torch.ops.align as port_align
import amira_tpu_torch.ops.hashing as port_hashing
import amira_tpu_torch.ops.host_tables as port_host_tables
from amira_tpu_torch.ops import sw_batch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "amira_tpu_torch")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_every_module_imports_without_jax_or_reference_package():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['amira_tpu'] = None\n"
        "import importlib, pkgutil, amira_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "amira_tpu_torch.__path__, 'amira_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'amira_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print(' '.join(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    names = out.stdout.split()
    assert len(names) >= 32
    assert {
        "amira_tpu_torch.promoters", "amira_tpu_torch.assembly", "amira_tpu_torch.graft_entry",
        "amira_tpu_torch.parallel.mesh", "amira_tpu_torch.parallel.multiproc",
        "amira_tpu_torch.scale_run", "amira_tpu_torch.accuracy_run",
    } <= set(names)


def test_no_source_file_imports_jax_or_reference_package():
    pattern = re.compile(r"\b(import|from)\s+(jax|amira_tpu)(?![\w])")
    offenders = []
    for root, _dirs, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                for i, line in enumerate(open(path), 1):
                    if pattern.search(line):
                        offenders.append(f"{path}:{i}: {line.strip()}")
    assert offenders == []


def test_constants_equal_reference():
    for name in (
        "NEG", "MATCH", "MISMATCH", "GAP_OPEN", "GAP_EXT", "GAP_OPEN2",
        "GAP_EXT2", "ZDROP",
    ):
        assert getattr(port_align, name) == getattr(jax_align, name), name
    for name in ("_GOLDEN", "_MIX1", "_MIX2"):
        ref = int(getattr(jax_hashing, name))
        assert getattr(port_hashing, name) & ((1 << 64) - 1) == ref, name
        assert int(getattr(port_host_tables, name)) == int(
            getattr(jax_host_tables, name)
        ), name
    assert port_host_tables.HOST_BATCH_GENE_LIMIT == jax_host_tables.HOST_BATCH_GENE_LIMIT
    assert port_align._OPS_STR == jax_align._OPS_STR
    assert (sw_batch.OP_EQ, sw_batch.OP_X, sw_batch.OP_I, sw_batch.OP_D) == (
        jax_align._OP_EQ, jax_align._OP_X, jax_align._OP_I, jax_align._OP_D,
    )


@pytest.mark.parametrize("Lq,W", [(64, 64), (128, 64), (256, 128), (2048, 256)])
def test_traceback_step_bound_matches_reference(Lq, W):
    S = jax_align._tb_steps(Lq, W)
    assert sw_batch.tb_steps(Lq, W) == (S + 255) // 256 * 256


def test_cuda_request_without_gpu_raises(monkeypatch, tmp_path):
    from amira_tpu_torch.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        amira_tpu_torch.resolve_device("cuda")
    argv = [
        "--pandoraJSON", "calls.json", "--gene-positions", "pos.json",
        "--reads", "reads.fastq", "--species", "Escherichia_coli",
        "--output", str(tmp_path / "out"), "--quiet",
    ]
    with pytest.raises(RuntimeError, match="cuda"):
        main(argv)  # --device defaults to cuda
    assert amira_tpu_torch.resolve_device("cpu").type == "cpu"


def test_dist_build_is_accepted_and_runs(tmp_path):
    """--dist-build runs the pipeline (on the CPU, one device: the
    single-device build) and writes the TSV of a run without it."""
    from amira_tpu_torch.__main__ import main
    from synthetic import make_isolate

    files = make_isolate(str(tmp_path / "data"), seed=1, n_reads=40)
    outs = {}
    for name, extra in (("plain", []), ("dist", ["--dist-build"])):
        out = str(tmp_path / name)
        argv = [
            "--pandoraJSON", files["calls"], "--gene-positions", files["positions"],
            "--reads", files["fastq"], "--species", "Escherichia_coli",
            "--amr-fasta", files["amr_fasta"], "--amr-calls", files["amr_calls"],
            "--core-genes", files["core_genes"], "--plasmid-genes", files["plasmid_genes"],
            "--output", out, "--quiet", "--device", "cpu", *extra,
        ]
        try:
            main(argv)
        except SystemExit as e:
            assert e.code in (None, 0)
        with open(os.path.join(out, "amira_results.tsv")) as f:
            outs[name] = f.read()
    assert outs["dist"] == outs["plain"]


@pytest.mark.parametrize(
    "extra",
    [
        ["--pandoraSam", "calls.sam", "--pandoraConsensus", "cons.fq", "--reads", "r.fq"],
        ["--panRG-path", "pan.panidx.zip", "--reads", "r.fq"],
        ["--pandoraJSON", "c.json", "--gene-positions", "p.json", "--assembly", "a.fa"],
        ["--pandoraJSON", "c.json", "--gene-positions", "p.json", "--reads", "r.fq",
         "--meta", "--promoter-mutations", "--assemble-paths", "--debug",
         "--no-dist-build"],
    ],
)
def test_single_isolate_features_are_ported(extra):
    """Every flag combination parses, and no feature is gated: the pipeline
    raises NotImplementedError for none (its gate, `check_ported`, went
    when --dist-build was ported)."""
    from amira_tpu_torch import pipeline
    from amira_tpu_torch.__main__ import get_options

    args = get_options(["--species", "Escherichia_coli", *extra])
    assert args.device == "cuda"
    assert not hasattr(pipeline, "check_ported")
    assert "NotImplementedError" not in inspect.getsource(pipeline)


# sha256 of amira_tpu/native/_fastio.c, which the port leaves as it is
JAX_FASTIO_SHA256 = "0386c0f30935ad2acbc1b4b86ac59040dd2d6cbc5f455e7044c3156f2526bc11"
# the lines of the JAX copy that the port's copy changes: the fast path's
# signature and its early return (the size ceiling), the output buffer's
# growth (the text ceiling), the argument parsing (the optional max_bytes)
# and two method docstrings (parse_fastq's, and pack_dna_chunk's stale one)
FASTIO_REMOVED = [
    " * (NULL with an exception set on real Python-level errors). */",
    "parse_fastq_fast(const char *path)",
    "    if (fsz <= 0) {",
    "        return NULL;",
    "                size_t ncap = outcap * 2;",
    '    if (!PyArg_ParseTuple(args, "s", &path))',
    "        return NULL;",
    "",
    "    PyObject *fast = parse_fastq_fast(path);",
    '     "parse_fastq(path) -> {name: (seq, qual)}"},',
    '     "pack_dna_chunk(seqs, start, chunk_codes) -> (words, bad, next_start)"},',
]


def test_native_helper_is_built_from_the_ports_own_copy():
    import difflib
    import hashlib
    import importlib

    build = importlib.import_module("amira_tpu_torch.native.build")
    assert os.path.dirname(build._SRC) == os.path.join(PORT_DIR, "native")
    with open(os.path.join(REPO, "amira_tpu", "native", "_fastio.c"), "rb") as g:
        jax_src = g.read()
    assert hashlib.sha256(jax_src).hexdigest() == JAX_FASTIO_SHA256
    with open(build._SRC, "rb") as f:
        port_src = f.read()
    diff = [
        line for line in difflib.unified_diff(
            jax_src.decode().splitlines(), port_src.decode().splitlines(), lineterm="", n=0
        )
        if line[:1] in "+-" and line[:3] not in ("+++", "---")
    ]
    assert [line[1:] for line in diff if line[0] == "-"] == FASTIO_REMOVED
    for line in (line[1:].strip() for line in diff if line[0] == "+"):
        assert (
            not line
            or line.startswith(("/*", "*", "}", "break;", "failed = 1", "return NULL;"))
            or any(w in line for w in ("max_bytes", "maxcap", "FASTQ_", "pack_dna_chunk(", "next_offset"))
        ), line


def _fastq_files(tmp_path):
    """A gzip FASTQ of random reads, the same uncompressed, and a gzip FASTQ
    of one read repeated (its text is over 16 times its file)."""
    import gzip

    rng = np.random.RandomState(3)
    records = []
    for i in range(400):
        seq = "".join(rng.choice(list("ACGT"), size=rng.randint(20, 600)))
        qual = "".join(rng.choice(list("!#5?I"), size=len(seq)))
        records.append(f"@read{i} extra words\n{seq}\n+\n{qual}\n")
    paths = {"gzip": tmp_path / "r.fastq.gz", "plain": tmp_path / "r.fastq",
             "repetitive_gzip": tmp_path / "rep.fastq.gz"}
    with gzip.open(paths["gzip"], "wt") as f:
        f.writelines(records)
    paths["plain"].write_text("".join(records))
    with gzip.open(paths["repetitive_gzip"], "wt") as f:
        f.writelines(f"@rep{i}\n{'A' * 2000}\n+\n{'I' * 2000}\n" for i in range(300))
    return paths


@pytest.mark.parametrize("kind", ["gzip", "plain", "repetitive_gzip"])
def test_native_parse_fastq_same_records_either_side_of_the_ceiling(kind, tmp_path, monkeypatch):
    """parse_fastq reads a file whole up to its size ceiling (an optional
    argument) and streams it above; the records are the same either way,
    and the same as the Python reader's."""
    from amira_tpu_torch import io as port_io
    from amira_tpu_torch.native import load

    native = load()
    assert native is not None
    path = str(_fastq_files(tmp_path)[kind])
    size = os.path.getsize(path)
    whole = native.parse_fastq(path)
    assert len(whole) == (300 if kind == "repetitive_gzip" else 400)
    for max_bytes in (size, size - 1, 1, 0):
        assert native.parse_fastq(path, max_bytes) == whole, max_bytes
    monkeypatch.setattr(amira_tpu_torch.native, "load", lambda: None)
    python = port_io.parse_fastq(path)  # the Python reader
    assert {k: (v["sequence"], v["quality"]) for k, v in python.items()} == {
        k: tuple(v) for k, v in whole.items()
    }


def _small_batch(device, W=64, lq=96, B=6, seed=5):
    rng = np.random.RandomState(seed)
    rlen = 2 * lq + 2 * W + 2 * lq
    qs = np.full((B, lq), 4, np.uint8)
    rs = np.full((B, rlen), 4, np.uint8)
    qlens = np.zeros(B, np.int32)
    dlos = np.full(B, -W // 2, np.int32)
    for b in range(B):
        n = rng.randint(16, lq)
        q = rng.randint(0, 4, size=n).astype(np.uint8)
        qs[b, :n] = q
        rs[b, W + lq : W + lq + n] = q
        qlens[b] = n
    return [torch.from_numpy(a).to(device) for a in (qs, rs, qlens, dlos)]


def _device_taking_entry_points():
    from amira_tpu_torch import assembly, graph_cache, preprocess, promoters, results
    from amira_tpu_torch.ops import consensus, kmer

    return [
        port_align.Aligner.__init__, kmer.KmerCounter.from_sequences,
        kmer.estimate_overall_read_depth, graph_cache.GraphBuildCache.__init__,
        results.get_closest_allele_from_polished, results.compare_reads_to_references,
        results.get_alleles, results.estimate_copy_numbers, consensus.polish_once,
        consensus.polish, preprocess.remove_poorly_mapped_genes,
        preprocess.convert_pandora_output, promoters.genotype_promoters,
        assembly.assemble_reads, assembly.assemble_path,
        assembly.assemble_full_length_paths,
    ]


@pytest.mark.parametrize("index", range(16))
def test_device_is_a_required_argument(index):
    fn = _device_taking_entry_points()[index]
    param = inspect.signature(fn).parameters["device"]
    assert param.default is inspect.Parameter.empty, fn.__qualname__


def test_polish_aligns_on_the_given_device(monkeypatch):
    from amira_tpu_torch.ops import consensus

    seen = []

    class Recording(consensus.Aligner):
        def __init__(self, *args, device, **kwargs):
            seen.append(device)
            super().__init__(*args, device=device, **kwargs)

    monkeypatch.setattr(consensus, "Aligner", Recording)
    rng = np.random.RandomState(2)
    draft = "".join(rng.choice(list("ACGT"), size=300))
    reads = {f"r{i}": draft[i * 10 : i * 10 + 200] for i in range(6)}
    assert consensus.polish(draft, reads, iterations=2, band_width=64, device="cpu") == draft
    assert seen and set(seen) == {"cpu"}


def test_cpu_tensors_take_the_plain_version():
    before = dict(sw_batch.LAUNCHES)
    args = _small_batch("cpu")
    got = sw_batch.sw_cigar(*args, 64)
    ref = sw_batch.sw_cigar_reference(*args, 64)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert sw_batch.LAUNCHES == before  # no kernel launch counted
    assert int(got[4].min()) == 2 * int(args[2].min())  # exact self-matches


def test_wrappers_refuse_other_devices():
    args = [torch.empty((2, 8), dtype=torch.uint8, device="meta")] * 2 + [
        torch.empty(2, dtype=torch.int32, device="meta")
    ] * 2
    with pytest.raises(ValueError, match="unsupported device"):
        sw_batch.sw_dp(*args, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("W,lq,B", [(128, 256, 40), (256, 192, 37)])
def test_sw_cigar_kernels_match_plain_version_on_gpu(W, lq, B, cuda_device):
    args = _small_batch(cuda_device, W=W, lq=lq, B=B)
    before = dict(sw_batch.LAUNCHES)
    got = sw_batch.sw_cigar(*args, W)
    ref = sw_batch.sw_cigar_reference(*args, W)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    assert sw_batch.LAUNCHES["sw_dp"] == before["sw_dp"] + 1
    assert sw_batch.LAUNCHES["sw_traceback"] == before["sw_traceback"] + 1
