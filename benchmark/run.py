"""The benchmark of `amira_tpu_torch` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. One run is one process:

1. Set-up: imports and CUDA initialisation, one isolate generated from
   `--seed` (`generate.py`, the cell's configuration and traffic), and
   the traffic's warm-up isolates through the same entry: small ones, or
   the window's own isolate once (the nvcc-built kernels and the native
   FASTQ reader are built into `amira_tpu_torch/_build/` by the first run
   in a checkout; the dense k-mer table's first use; the host memory that
   the first isolate of a process pays for).
   `setup_s` is the process's start to the window's start.
2. The window: the isolate through the CLI's own parser into
   `pipeline.run_pipeline` with `--device cuda --quiet`, into a fresh
   output directory each time, back to back while `--seconds` has not
   elapsed; the isolate in flight then ends it. `reads_per_s` is all reads
   run over the seconds from the first isolate's start to the last one's
   end. With `--trace 1` the window runs under `torch.profiler` (CUDA
   activity), with the program's phases and the SW kernels' inputs
   recorded from here, and the per-layer metrics are reported instead.
3. The check: every isolate's answer against the plain reference
   (`reference.py`), each number beside its limit (the cell's "limits").

The last line of standard output is the result, a JSON object. The run
fails without a card, without the package, or if JAX or the JAX package
was loaded. Everything it writes goes under `bench_work/` in the checkout,
removed at the end; caches go under `.bench_cache/`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import io  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _p in (str(HERE), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import bounds  # noqa: E402
import devtrace  # noqa: E402
import faults  # noqa: E402
import generate  # noqa: E402
import reference  # noqa: E402
import score  # noqa: E402
import spec  # noqa: E402

PACKAGE = "amira_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "amira_tpu")
WORK = ROOT / "bench_work"
CACHE = ROOT / ".bench_cache"
# the configuration's "defaults" as the CLI takes them
FLAGS = {
    "node_min_coverage": "-n",
    "gene_min_coverage": "-g",
    "lower_gene_length_threshold": "--minimum-length-proportion",
    "upper_gene_length_threshold": "--maximum-length-proportion",
    "identity": "--identity",
    "coverage": "--coverage",
    "min_relative_depth": "--min-relative-depth",
    "sample_size": "--sample-size",
    "seed": "--seed",
}


def log(msg: str) -> None:
    sys.stderr.write(f"bench: {msg}\n")
    sys.stderr.flush()


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    port's own nvcc and gcc builds go to `amira_tpu_torch/_build/`)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def cli_argv(params: dict, files: dict, out_dir: str, device: str) -> list[str]:
    if params["route"] == "sam":
        calls = ["--pandoraSam", files["sam"], "--pandoraConsensus", files["consensus"]]
    else:
        calls = ["--pandoraJSON", files["calls"], "--gene-positions", files["positions"]]
    argv = calls + [
        "--reads", files["fastq"], "--species", params["species"],
        "--amr-fasta", files["amr_fasta"], "--amr-calls", files["amr_calls"],
        "--core-genes", files["core_genes"], "--plasmid-genes", files["plasmid_genes"],
        "--output", out_dir, "--quiet", "--device", device,
    ]
    for key, flag in FLAGS.items():
        argv += [flag, str(params["defaults"][key])]
    return argv


def sync(device: str) -> None:
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()


def run_isolate(params: dict, files: dict, out_dir: str, device: str) -> dict:
    """One isolate through the CLI's parser into `run_pipeline`. Returns
    its record: host start and end, phases, the program's standard error
    and the error that stopped it, if any."""
    from amira_tpu_torch.__main__ import get_options
    from amira_tpu_torch.pipeline import run_pipeline
    from amira_tpu_torch.tracing import TIMER

    err = None
    exited = False
    buf = io.StringIO()
    start = time.perf_counter()
    try:
        with contextlib.redirect_stderr(buf):
            run_pipeline(get_options(cli_argv(params, files, out_dir, device)))
    except SystemExit as e:  # the pipeline exits when it finds no AMR gene
        err, exited = f"the pipeline exited with {e.code!r} before writing a result", True
    except Exception:  # noqa: BLE001 - an isolate that fails is counted, not fatal
        err = traceback.format_exc()
    sync(device)
    end = time.perf_counter()
    return {
        "start": start,
        "end": end,
        "wall_s": end - start,
        "phases": [{"phase": p["phase"], "seconds": p["seconds"]} for p in TIMER.phases],
        "out": out_dir,
        "stderr": buf.getvalue(),
        "error": err,
        "exited": exited,
    }


class Cell:
    """A cell's set-up: its parameters, warm-up and isolates."""

    def __init__(self, name: str, device: str, overrides: dict | None = None):
        self.name = name
        self.device = device
        self.entry, self.params = spec.cell(name)
        self.params.update(overrides or {})
        self.work = WORK / name
        shutil.rmtree(self.work, ignore_errors=True)
        self.work.mkdir(parents=True)
        self.generation_s = 0.0
        self._runs = 0

    def make_isolate(self, seed: int, tag: str, **over) -> dict:
        t = time.perf_counter()
        files = generate.make_isolate(str(self.work / tag), seed, dict(self.params, **over))
        self.generation_s += time.perf_counter() - t
        return files

    def out_dir(self) -> str:
        self._runs += 1
        return str(self.work / "out" / f"isolate{self._runs}")

    def warm_up(self, seed: int, inputs: dict | None = None) -> list[dict]:
        """The cell's warm-up isolates, each once through the same entry (one
        may find no AMR gene and exit; one that raises stops the run). With
        the traffic's "warmup_own", `inputs`, the window's own isolate, then
        runs once too, so that the window's first isolate finds the host's
        memory as later ones do."""
        recs = []
        runs = [(dict(self.params, **over), over, f"warm-up isolate {i}")
                for i, over in enumerate(self.params.get("warmup", []))]
        if inputs is not None and self.params.get("warmup_own"):
            runs.append((self.params, None, "the window's isolate, run as a warm-up"))
        for i, (params, over, what) in enumerate(runs):
            files = inputs if over is None else self.make_isolate(seed, f"warmup{i}", **over)
            rec = run_isolate(params, files, self.out_dir(), self.device)
            if rec["error"] and not rec["exited"]:
                raise RuntimeError(f"{what} failed:\n{rec['error']}")
            recs.append(rec)
        return recs

    def window(self, files: dict, seconds: float) -> list[dict]:
        """Isolates back to back while `seconds` have not elapsed. Each
        starts after a full garbage collection, counted in the window, so
        no isolate pays for the one before it at a moment of the
        collector's choosing."""
        isolates = []
        t0 = time.perf_counter()
        while True:
            gc.collect()
            isolates.append(run_isolate(self.params, files, self.out_dir(), self.device))
            if isolates[-1]["end"] - t0 >= seconds:
                return isolates

    def judge(self, rec: dict, files: dict) -> dict:
        """The isolate's numbers against the reference (empty if it failed)."""
        if rec["error"]:
            return {}
        truth = files["truth"]
        nums = reference.judge(rec["out"], truth)
        if self.params["route"] == "sam":
            nums.update(reference.judge_sam(rec["out"], files, truth, self.params, rec["stderr"]))
        return nums

    def close(self) -> None:
        shutil.rmtree(self.work, ignore_errors=True)


@contextlib.contextmanager
def recorded(spans: list, launches: dict):
    """Records the program's phases as host spans and each SW kernel
    launch's inputs, from outside the program, for the traced window."""
    import torch

    from amira_tpu_torch.ops import sw_batch
    from amira_tpu_torch.tracing import TIMER

    real_phase, real_dp, real_tb = TIMER.phase, sw_batch.sw_dp, sw_batch.sw_traceback

    @contextlib.contextmanager
    def phase(name, **meta):
        t = time.perf_counter()
        with real_phase(name, **meta) as entry:
            yield entry
        spans.append((name, t, time.perf_counter()))

    def sw_dp(qs, rs, qlens, dlos, W):
        out = real_dp(qs, rs, qlens, dlos, W)
        launches["sw_dp"].append((qlens, W))
        return out

    def sw_traceback(tb, best, bi, bw, bs, dlos, W):
        out = real_tb(tb, best, bi, bw, bs, dlos, W)
        # the packed output's shape without its memory, and the steps
        launches["sw_traceback"].append((torch.empty(out[0].shape, device="meta"), out[1]))
        return out

    TIMER.phase, sw_batch.sw_dp, sw_batch.sw_traceback = phase, sw_dp, sw_traceback
    try:
        yield
    finally:
        del TIMER.phase
        sw_batch.sw_dp, sw_batch.sw_traceback = real_dp, real_tb


def kernel_bounds_ms(launches: dict) -> dict:
    """Each kernel's summed bound over its launches (ms)."""
    return {
        "sw_dp": sum(bounds.dp_bound(q, W)[1][0] for q, W in launches["sw_dp"]),
        "sw_traceback": sum(bounds.tb_bound(p, steps)[0] for p, steps in launches["sw_traceback"]),
    }


def run_cell(name, seed, seconds, trace=False, device="cuda", overrides=None, fault=None):
    """One run of a cell. Returns (result, earlier lines); the result lacks
    nothing but the check for JAX."""
    cell = Cell(name, device, overrides)
    lines = []
    files = cell.make_isolate(seed, "input")
    t = time.perf_counter()
    warm = cell.warm_up(seed, files)
    walls = ", ".join(f"{r['wall_s']:.3f}" for r in warm)
    lines.append(
        f"set-up: generation {cell.generation_s:.3f} s (this run's isolate and the warm-up's), "
        f"warm-up isolates {time.perf_counter() - t:.3f} s ({walls})"
    )
    setup_s = time.perf_counter() - T_START
    spans, launches = [], {"sw_dp": [], "sw_traceback": []}
    trace_summary = None
    with faults.planted(fault):
        if trace:
            with recorded(spans, launches), devtrace.Profiler() as prof:
                isolates = cell.window(files, seconds)
            t0, t1 = isolates[0]["start"], isolates[-1]["end"]
            trace_summary = devtrace.summarise(prof.device_records(), t0, t1, spans)
            if trace_summary["busy_s"] <= 0:
                raise RuntimeError("the profiler shows no device time on the card")
        else:
            isolates = cell.window(files, seconds)
    device_info = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if device.startswith("cuda"):
        import torch

        device_info = {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": cell.entry["chips"],
            "memory_peak_bytes": max(
                torch.cuda.max_memory_allocated(i) for i in range(cell.entry["chips"])
            ),
        }
    if trace_summary is not None:
        device_info["busy_s"] = trace_summary["busy_s"]
        device_info["window_s"] = trace_summary["window_s"]
    kernel_bounds = kernel_bounds_ms(launches) if trace else {}
    launches.clear()

    run = {
        "reads": int(cell.params["reads"]),
        "setup_s": setup_s,
        "isolates": isolates,
        "trace": trace_summary,
        "kernel_bounds_ms": kernel_bounds,
    }
    for i, rec in enumerate(isolates):
        phases = ", ".join(f"{p['phase']} {p['seconds']}" for p in rec["phases"])
        lines.append(f"isolate {i + 1}: {rec['wall_s']:.3f} s; phases: {phases}")
        if rec["error"]:
            lines.append(f"isolate {i + 1} failed: {rec['error'].strip()}")
    limits = cell.params["limits"]
    numbers: dict = {}
    failed = 0
    for rec in isolates:
        nums = cell.judge(rec, files)
        if not nums or any(nums[k] > limits[k] for k in limits):
            failed += 1
        for k, v in nums.items():
            numbers[k] = max(numbers.get(k, v), v)
    if not isolates[0]["error"]:
        acc = score.score(isolates[0]["out"], files["truth"])
        lines.append(
            f"accuracy: rows {acc['rows']}, copy recall {acc['copy_recall']}, "
            f"copy precision {acc['copy_precision']}; numbers not compared: "
            f"{ {k: v for k, v in numbers.items() if k not in limits} }"
        )
    # a number that could not be read (a failed isolate, a copy number
    # that is not a number) is null, and fails
    checks = {}
    for k, limit in limits.items():
        value = numbers.get(k, math.inf)
        checks[k] = {"value": value if math.isfinite(value) else None, "limit": limit}
    correct = failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"] for c in checks.values()
    )

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(name, kind):
        value = spec.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {
        "correct": correct,
        "attempted": len(isolates),
        "failed": failed,
        "metrics": metrics,
        "device": device_info,
    }
    if trace_summary is not None:
        result["breakdown"] = {
            "device_ops": trace_summary["device_ops"],
            "idle_gaps": trace_summary["idle_gaps"],
        }
        lines.append(
            f"trace: {trace_summary['records']} device records, busy {trace_summary['busy_s']:.6f} s "
            f"of {trace_summary['window_s']:.6f} s; kernel bounds (ms) {kernel_bounds}"
        )
    result["checks"] = checks
    cell.close()
    lines.append(f"disk: {written_bytes()} bytes written by this process")
    return result, lines


def written_bytes() -> int | None:
    """Bytes this process has written through system calls (Linux's
    `wchar`: files, including those removed later)."""
    try:
        with open("/proc/self/io") as f:
            return next(int(ln.split()[1]) for ln in f if ln.startswith("wchar"))
    except (OSError, StopIteration):
        return None


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that are JAX or the JAX package."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / PACKAGE / "__init__.py").exists():
        log(f"{PACKAGE} is not in this checkout ({ROOT}): nothing to measure")
        return 2
    cache_env()
    entry, _params = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        log(
            f"the cell needs {entry['chips']} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}"
        )
        return 3
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = loaded_forbidden()
    if found:
        log(f"JAX or the JAX package was loaded in this process: {found}")
        return 4
    for line in lines:
        log(line)
    log(f"device: {result['device']}")
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
