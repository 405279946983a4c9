"""The port's run scripts against the repo's JAX ones, on the CPU, exactly.

`amira_tpu_torch.scale_run` is held to `scale_run.py` (the same isolate and
--reuse marker from --generate-only, the same amira_results.tsv and phase
names from --reuse on one workdir) and `amira_tpu_torch.accuracy_run` to
`accuracy_run.py` (the same scorer, the same JSON values and table rows).
Every script runs in a child process with PYTHONHASHSEED=0, since the
generator's bases follow string hashing. The read counts are the smallest
multiples of 500 at which the JAX scripts call amrX x2 + amrY, and each
test asserts that they did, so no comparison is vacuous.
"""

from __future__ import annotations

import gzip
import hashlib
import json
import os
import random
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import accuracy_run as jax_accuracy  # noqa: E402
from amira_tpu_torch import accuracy_run, scale_run  # noqa: E402

SCALE_READS = 2500  # scale_run.py, seed 17: 2,000 reads give one AMR row
ACCURACY_READS = 1500  # accuracy_run.py, seed 23: 1,000 reads give one
EXPECTED_GENES = ["amrX", "amrX", "amrY"]
# the port's top-level phases that the JAX package has no phase for
PORT_ONLY_PHASES = ("reference_setup", "graph_trim", "graph_prune", "write_outputs", "result_table")


def _start(argv: list[str]) -> subprocess.Popen:
    env = dict(os.environ, PYTHONHASHSEED="0", JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, *argv], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def _finish(*procs) -> list[tuple[str, str]]:
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"{p.args}\n{out[-3000:]}\n{err[-3000:]}"
    return outs


def _file_digest(path: str) -> str:
    """SHA-256 of a file's bytes; of a gzip file's decompressed bytes (its
    header holds the time it was written)."""
    if path.endswith(".gz"):
        return scale_run.fastq_sha256(path)
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _genes(tsv: str) -> list[str]:
    with open(tsv) as f:
        return sorted(line.split("\t")[0] for line in f.read().splitlines()[1:])


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """(JAX workdir, twin workdir) after each script's --generate-only."""
    base = tmp_path_factory.mktemp("scale_generated")
    jax_dir, twin_dir = str(base / "jax"), str(base / "twin")
    common = ["--generate-only", "--reads", str(SCALE_READS), "--workdir"]
    _finish(
        _start(["scale_run.py", "--cpu", *common, jax_dir]),
        _start(["-m", "amira_tpu_torch.scale_run", "--device", "cpu", *common, twin_dir]),
    )
    return jax_dir, twin_dir


@pytest.fixture(scope="module")
def reuse_runs(generated, tmp_path_factory):
    """Both scripts with --reuse, each on its own copy of the JAX script's
    workdir: (JAX workdir, twin workdir, JAX stderr, twin stderr)."""
    base = tmp_path_factory.mktemp("scale_reuse")
    jax_dir, twin_dir = str(base / "jax"), str(base / "twin")
    shutil.copytree(generated[0], jax_dir)
    shutil.copytree(generated[0], twin_dir)
    common = ["--reuse", "--reads", str(SCALE_READS), "--workdir"]
    (_, jax_err), (_, twin_err) = _finish(
        _start(["scale_run.py", "--cpu", *common, jax_dir]),
        _start(["-m", "amira_tpu_torch.scale_run", "--device", "cpu", *common, twin_dir]),
    )
    return jax_dir, twin_dir, jax_err, twin_err


@pytest.fixture(scope="module")
def accuracy_runs(tmp_path_factory):
    """Both accuracy scripts at ACCURACY_READS, 2 %/1 %: (JAX stdout, twin
    stdout, JAX workdir)."""
    base = tmp_path_factory.mktemp("accuracy")
    common = ["--reads", str(ACCURACY_READS), "--workdir"]
    (jax_out, _), (twin_out, _) = _finish(
        _start(["accuracy_run.py", "--cpu", *common, str(base / "jax")]),
        _start(["-m", "amira_tpu_torch.accuracy_run", "--device", "cpu", *common, str(base / "twin")]),
    )
    return jax_out, twin_out, str(base / "jax")


def _table_rows(stdout: str) -> list[str]:
    return [line for line in stdout.splitlines() if line.startswith("| amr")]


def test_edit_distance_and_identity_equal_accuracy_run_on_fuzz():
    rng = random.Random(0)
    for _ in range(300):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 40)))
        b = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, 40)))
        assert accuracy_run.edit_distance(a, b) == jax_accuracy.edit_distance(a, b)
        assert accuracy_run.identity(a, b) == jax_accuracy.identity(a, b)


@pytest.mark.parametrize(
    "a,b", [("", ""), ("", "ACGT"), ("ACGT", ""), ("A", "A"), ("ACGTACGT", "ACGTACGA"), ("AAAA", "TTTT")]
)
def test_edit_distance_and_identity_equal_accuracy_run_at_edges(a, b):
    assert accuracy_run.edit_distance(a, b) == jax_accuracy.edit_distance(a, b)
    assert accuracy_run.identity(a, b) == jax_accuracy.identity(a, b)


def test_generate_only_gives_scale_runs_files_and_marker(generated):
    jax_dir, twin_dir = generated
    jax_files = sorted(os.listdir(jax_dir))
    twin_files = sorted(os.listdir(twin_dir))
    markers = [f for f in jax_files if f.startswith(".generated_")]
    assert len(markers) == 1
    marker = markers[0]
    assert marker == os.path.basename(
        scale_run.marker_path(twin_dir, SCALE_READS, scale_run.isolate_kwargs())
    )
    # the twin adds only its record of the generation beside the marker
    assert twin_files == sorted(jax_files + [marker + ".json"])
    for f in jax_files:
        assert _file_digest(os.path.join(jax_dir, f)) == _file_digest(os.path.join(twin_dir, f)), f
    with open(os.path.join(twin_dir, marker + ".json")) as f:
        record = json.load(f)
    assert record["fastq_sha256"] == scale_run.fastq_sha256(os.path.join(jax_dir, "reads.fastq.gz"))
    assert record["n_reads"] == SCALE_READS


def test_reuse_runs_write_the_same_tsv_and_phases(reuse_runs):
    jax_dir, twin_dir, jax_err, twin_err = reuse_runs
    assert "reusing generated isolate" in jax_err and "reusing generated isolate" in twin_err
    jax_tsv = os.path.join(jax_dir, "out", "amira_results.tsv")
    twin_tsv = os.path.join(twin_dir, "out", "amira_results.tsv")
    assert _genes(jax_tsv) == EXPECTED_GENES
    with open(jax_tsv, "rb") as f, open(twin_tsv, "rb") as g:
        assert f.read() == g.read()
    phases = []
    for d in (jax_dir, twin_dir):
        with open(os.path.join(d, "out", "phase_timings.json")) as f:
            phases.append([p["phase"] for p in json.load(f)])
    # the port's phases over what the JAX package leaves untimed
    assert [p for p in phases[1] if p not in PORT_ONLY_PHASES] == phases[0]
    with open(os.path.join(twin_dir, "out", "scale_summary.json")) as f:
        summary = json.load(f)
    assert summary["generation_reused"] and summary["amr_rows"] == 3
    assert list(summary["phases"]) == list(dict.fromkeys(phases[1]))
    assert set(summary["cleaning_stages"]) >= {"clean.build", "clean.tips", "clean.bubbles"}
    assert summary["platform"] == "cpu" and summary["peak_device_memory_bytes"] is None
    assert os.path.exists(os.path.join(twin_dir, "out", "SCALE_REPORT.md"))


def test_accuracy_run_equals_the_jax_script(accuracy_runs):
    jax_out, twin_out, jax_dir = accuracy_runs
    jax_line = json.loads(jax_out.strip().splitlines()[-1])
    twin_line = json.loads(twin_out.strip().splitlines()[-1])
    assert jax_line["copy_recall"] == 1.0 and jax_line["copy_precision"] == 1.0
    for key, value in jax_line.items():
        assert twin_line[key] == value, key
    jax_rows, twin_rows = _table_rows(jax_out), _table_rows(twin_out)
    assert len(jax_rows) == 3 and jax_rows == twin_rows
    # the twin's scorer on the JAX script's own output gives its numbers
    with open(os.path.join(jax_dir, "truth.json")) as f:
        got = accuracy_run.score(os.path.join(jax_dir, "out"), json.load(f))
    assert round(100 * got["mean_identity"], 2) == jax_line["value"]
    assert round(got["copy_recall"], 4) == jax_line["copy_recall"]
    assert round(got["copy_precision"], 4) == jax_line["copy_precision"]
    assert sorted(r[1] for r in got["rows"]) == EXPECTED_GENES


@pytest.mark.parametrize("module", [scale_run, accuracy_run], ids=["scale_run", "accuracy_run"])
def test_twins_raise_without_cuda_by_default(module, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(["--reads", "10", "--workdir", str(tmp_path / "w")])
    assert not (tmp_path / "w").exists()  # nothing was generated
