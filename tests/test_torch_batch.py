"""The port's batch driver (`amira_tpu_torch.batch`) on the CPU, and the
repairs it rests on: per-thread phase timers, `--device cuda:N`, and the
device guard around every kernel launch.

A manifest of two `make_isolate` isolates (seed 0 with 60 reads, seed 3
with 70) runs through the JAX package's `run_batch`, the port's
`run_batch` with one and with two workers, and the port's CLI one isolate
at a time; every amira_results.tsv must equal the others byte for byte,
and each isolate's phase_timings.json must hold its own phases (the names,
outputs, order and item counts of its single run, and its own SW launches
in the `align.kernels` spans' counters) and nothing else.

Tolerance: zero; files are compared byte for byte, counts exactly.
"""

import collections
import json
import os
import subprocess
import sys
import types

import pytest
import torch

import amira_tpu_torch
from amira_tpu_torch import batch
from amira_tpu_torch.ops import sw_batch
from synthetic import make_isolate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name: (seed, reads); the read counts differ, so the phases' item counts
# tell the isolates apart
ISOLATES = {"iso_seed0": (0, 60), "iso_seed3": (3, 70)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain SW versions run many small torch ops: one intra-op thread
    is as fast here, and keeps parallel test workers off each other's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _entry(files, name, outdir):
    return {
        "name": name,
        "pandoraJSON": files["calls"],
        "gene-positions": files["positions"],
        "reads": files["fastq"],
        "species": "Escherichia_coli",
        "amr-fasta": files["amr_fasta"],
        "amr-calls": files["amr_calls"],
        "core-genes": files["core_genes"],
        "plasmid-genes": files["plasmid_genes"],
        "output": os.path.join(outdir, name),
        "quiet": True,
    }


def _read(path):
    with open(path) as f:
        return f.read()


def _kernel_counters(entry):
    """The `align.kernels` counters summed over the spans under `entry`, as
    sorted (name, total) pairs."""
    total = collections.Counter()
    for s in entry.get("spans", []):
        if s["span"] == "align.kernels":
            total.update(s["counters"])
        total.update(dict(_kernel_counters(s)))
    return tuple(sorted(total.items()))


def _phases(outdir):
    with open(os.path.join(outdir, "phase_timings.json")) as f:
        return [
            (p["phase"], p.get("items"), p.get("output"), _kernel_counters(p))
            for p in json.load(f)
        ]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every isolate through the JAX batch (two workers), the port's batch
    with one and with two workers, and the port's CLI alone. Returns
    {run name: {isolate: output directory}} and the port batches'
    summaries."""
    from amira_tpu.batch import run_batch as jax_run_batch
    from amira_tpu_torch.__main__ import main

    root = tmp_path_factory.mktemp("batch")
    files = {
        name: make_isolate(str(root / "data" / name), seed=seed, n_reads=n)
        for name, (seed, n) in ISOLATES.items()
    }
    out = {}
    summaries = {}
    manifest = lambda d: [_entry(files[n], n, str(root / d)) for n in ISOLATES]  # noqa: E731
    jax_summaries = jax_run_batch(manifest("jax"), workers=2, quiet=True)
    assert [s["status"] for s in jax_summaries] == ["ok", "ok"]
    out["jax"] = {n: str(root / "jax" / n) for n in ISOLATES}
    for workers in (1, 2):
        d = f"port_w{workers}"
        summaries[d] = batch.run_batch(manifest(d), workers=workers, quiet=True, device="cpu")
        out[d] = {n: str(root / d / n) for n in ISOLATES}
    out["single"] = {}
    for n in ISOLATES:
        e = _entry(files[n], n, str(root / "single"))
        argv = batch._entry_to_argv(e, None, 0) + ["--device", "cpu"]
        try:
            main(argv)
        except SystemExit as exc:
            assert exc.code in (None, 0)
        out["single"][n] = e["output"]
    return out, summaries


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("name", list(ISOLATES))
def test_batch_tsv_equals_jax_batch(runs, name, workers):
    out, _ = runs
    tsv = _read(os.path.join(out[f"port_w{workers}"][name], "amira_results.tsv"))
    assert tsv == _read(os.path.join(out["jax"][name], "amira_results.tsv"))
    assert "amrX" in tsv


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("name", list(ISOLATES))
def test_batch_tsv_equals_single_port_run(runs, name, workers):
    out, _ = runs
    tsv = _read(os.path.join(out[f"port_w{workers}"][name], "amira_results.tsv"))
    assert tsv == _read(os.path.join(out["single"][name], "amira_results.tsv"))


@pytest.mark.parametrize("workers", [1, 2])
def test_batch_summaries(runs, workers):
    out, summaries = runs
    got = summaries[f"port_w{workers}"]
    assert [s["status"] for s in got] == ["ok"] * len(ISOLATES)
    assert [s["output"] for s in got] == list(out[f"port_w{workers}"].values())
    for s in got:
        assert s["results_tsv"] == os.path.join(s["output"], "amira_results.tsv")
        assert s["seconds"] > 0


@pytest.mark.parametrize("name", list(ISOLATES))
def test_each_isolate_times_only_its_own_phases(runs, name):
    out, _ = runs
    own = _phases(out["single"][name])
    assert own and len({p[:3] for p in own}) == len(own)
    # polishing's launches are counted in its own spans, once an isolate
    assert [dict(p[3])["launches"] > 0 for p in own if p[3]] == [True]
    for workers in (1, 2):
        assert _phases(out[f"port_w{workers}"][name]) == own
    # the two isolates differ in reads, so mixed phases would show
    assert len(set(tuple(_phases(out["single"][n])) for n in ISOLATES)) == len(ISOLATES)


def test_bad_isolate_gives_an_error_summary_and_early_exit_is_ok(tmp_path):
    no_amr = make_isolate(
        str(tmp_path / "no_amr"), seed=1, n_reads=30,
        layout=["geneA", "geneB", "geneC", "geneD"], amr_genes=("amrZ",),
    )
    manifest = [
        {
            "name": "broken",
            "pandoraJSON": "/does/not/exist.json",
            "gene-positions": "/does/not/exist_pos.json",
            "reads": "/does/not/exist.fastq",
            "species": "Escherichia_coli",
            "amr-fasta": "/does/not/exist.fa",
            "quiet": True,
        },
        _entry(no_amr, "no_amr", str(tmp_path / "out")),
    ]
    summaries = batch.run_batch(manifest, str(tmp_path), workers=2, quiet=True, device="cpu")
    assert len(summaries) == 2
    assert summaries[0]["status"].startswith("error:")
    assert summaries[0]["output"] == os.path.join(str(tmp_path), "broken")
    assert summaries[1]["status"] == "ok"  # the pipeline's early SystemExit(0)


def test_manifest_cli(tmp_path):
    files = make_isolate(
        str(tmp_path / "iso1"), seed=1, n_reads=30,
        layout=["geneA", "geneB", "geneC", "geneD"], amr_genes=("amrZ",),
    )
    entry = _entry(files, "iso1", str(tmp_path / "out"))
    del entry["output"]
    mpath = str(tmp_path / "manifest.json")
    with open(mpath, "w") as fh:
        json.dump([entry], fh)
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-m", "amira_tpu_torch.batch", mpath, "--workers", "1",
         "--quiet", "--device", "cpu", "--output-root", str(tmp_path / "root")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    summaries = json.loads(proc.stdout)
    out = os.path.join(str(tmp_path / "root"), "iso1")
    assert summaries == [
        {"output": out, "status": "ok", "seconds": summaries[0]["seconds"],
         "results_tsv": os.path.join(out, "amira_results.tsv")}
    ]
    assert os.path.exists(os.path.join(out, "amira_results.tsv"))


def test_entry_to_argv_matches_reference():
    from amira_tpu.batch import _entry_to_argv as jax_entry_to_argv

    entry = {"name": "a", "reads": "r.fq", "quiet": True, "debug": False,
             "n": 2, "meta": None}
    for root in (None, "root"):
        assert batch._entry_to_argv(entry, root, 4) == jax_entry_to_argv(entry, root, 4)
    assert batch._entry_to_argv({"reads": "r"}, None, 4)[-1] == os.path.join(
        "amira_batch_output", "isolate_4"
    )


@pytest.mark.parametrize("value", ["cuda:0", "cuda:3", "cuda", "cpu"])
def test_device_flag_takes_cuda_index(value):
    from amira_tpu_torch.__main__ import get_options

    argv = ["--species", "Escherichia_coli", "--pandoraJSON", "c.json",
            "--gene-positions", "p.json", "--reads", "r.fq", "--device", value]
    assert get_options(argv).device == value
    with pytest.raises(SystemExit):
        get_options(argv[:-1] + [value.replace("cuda", "gpu") if "cuda" in value else "cpu:0"])


def test_missing_cuda_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert amira_tpu_torch.resolve_device("cuda:1") == torch.device("cuda", 1)
    assert amira_tpu_torch.visible_devices("cuda") == [
        torch.device("cuda", 0), torch.device("cuda", 1)
    ]
    assert amira_tpu_torch.visible_devices("cuda:1") == [torch.device("cuda", 1)]
    assert amira_tpu_torch.visible_devices("cpu") == [torch.device("cpu")]
    with pytest.raises(RuntimeError, match="cuda:2"):
        amira_tpu_torch.resolve_device("cuda:2")
    with pytest.raises(RuntimeError, match="cuda:5"):
        batch.run_batch([{"reads": "r.fq"}], device="cuda:5")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda:0"):
        amira_tpu_torch.resolve_device("cuda:0")


class _FakeCudaTensor:
    """Enough of a CUDA tensor for the wrappers' checks on a CPU build."""

    def __init__(self, shape, dtype, device):
        self.shape = tuple(shape) if isinstance(shape, (tuple, list)) else (shape,)
        self.dtype = dtype
        self.device = torch.device(device)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 4096

    def numel(self):
        n = 1
        for s in self.shape:
            n *= s
        return n


def test_every_launch_is_inside_its_device_guard(monkeypatch):
    """sw_dp, sw_traceback and the re-stage read make their tensors' device
    current around the launch and hand the launcher that device's current
    stream (fault F1: without the guard, a launch for cuda:1 from a thread
    whose current device is cuda:0 goes to cuda:0)."""
    dev = torch.device("cuda", 1)
    current = []
    calls = []

    class Guard:
        def __init__(self, d):
            self.d = torch.device(d)

        def __enter__(self):
            current.append(self.d)

        def __exit__(self, *exc):
            current.pop()

    def stream_of(d):
        return types.SimpleNamespace(
            cuda_stream=100 + torch.device(d).index,
            synchronize=lambda: calls.append(("sync", list(current))),
        )

    def launcher(name):
        def launch(*args):
            calls.append((name, list(current), args[-1]))
            return 0
        return launch

    fake_lib = types.SimpleNamespace(
        sw_dp_launch=launcher("sw_dp"), sw_traceback_launch=launcher("sw_traceback"),
        sw_traceback_restages=lambda count, reset: calls.append(("restages", list(current))) or 0,
    )
    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream", stream_of)
    monkeypatch.setattr(torch, "empty", lambda shape, dtype, device: _FakeCudaTensor(shape, dtype, device))
    monkeypatch.setattr(sw_batch, "build", lambda: None)
    monkeypatch.setattr(sw_batch, "_lib", fake_lib)
    monkeypatch.setattr(sw_batch, "LAUNCHES", {"sw_dp": 0, "sw_traceback": 0})
    monkeypatch.setattr(sw_batch, "DP_SHAPES", collections.Counter())

    B, Lq, W = 5, 32, 64
    u8, i32 = torch.uint8, torch.int32
    qs, rs = _FakeCudaTensor((B, Lq), u8, dev), _FakeCudaTensor((B, 300), u8, dev)
    ints = [_FakeCudaTensor((B,), i32, dev) for _ in range(5)]
    tb, best, bi, bw, bs = sw_batch.sw_dp(qs, rs, ints[0], ints[1], W)
    sw_batch.sw_traceback(tb, best, bi, bw, bs, ints[1], W)
    sw_batch.traceback_restages(reset=True, device=dev)
    assert calls == [
        ("sw_dp", [dev], 101), ("sw_traceback", [dev], 101),
        ("sync", [dev]), ("restages", [dev]),
    ]
    assert current == []
    assert sw_batch.LAUNCHES == {"sw_dp": 1, "sw_traceback": 1}
    assert sw_batch.DP_SHAPES == {(B, Lq, W): 1}
