#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (`amira_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--reads N]

Run from the root of a checkout. Phases, each printing its own lines:

1. Device and build: the card's name and power limit (nvidia-smi), and the
   nvcc build of the hand-written kernels in amira_tpu_torch/csrc/, with
   ptxas's register and spill report.
2. Kernels against their plain PyTorch versions on the card, exactly, at
   the test shapes (the last with padded jobs, query lengths 1 and < W/32,
   strongly negative diagonals and a ragged last block) and at the
   production shapes: the two large sw_dp launches of the 50k-read main
   path, (B, Lq) = (980, 1024) and (490, 1024), and (512, 2048), all at
   W=256, each with CUDA-event times of both and each kernel's bound. The
   traceback is timed as the main path calls it, each launch right after a
   fresh sw_dp on the same inputs, beside its longest walk, its time per
   step of that walk and its re-stages per walk. sw_traceback is then held
   to its plain version on random traceback bytes (long gap runs, clamped
   lanes, walks that reach the step cap), up to (W, Lq, B) = (256, 1024,
   980). Then a sweep of sw_dp at Lq=2048, W=256 over B = 128, 512, 1024,
   2048 (ms, Gcell/s over live cells), exact against the plain version at
   every point.
3. The committed golden: the CLI with --device cuda on the seed-7 isolate
   must write tests/goldens/amira_results_seed7.tsv byte for byte.
4. The main path at a real isolate size: a 4,003-slot E. coli-like genome,
   amrX at two loci plus amrY, 10-20 genes (4-8 kb) per read, 5% gene-call
   noise, seed 17, --reads reads (default 50,000, about 300 Mbp). The CLI
   runs with --device cuda; the result must be two amrX rows and one amrY
   row matching allele NG001 at >= 99% identity, every kernel of the path
   must have launched, the large graph build must have hashed its windows
   on the card and the dense k-mer table must have lived there.

The next-to-last lines are the card line and one JSON object describing
each kernel; the last line is {"ok": true, "device": {...}}. Any failed
phase exits non-zero without that line, as does a machine without CUDA.
The kernels JSON line reports each kernel at the main path's largest
launch, (B, Lq, W) = (980, 1024, 256). Data, outputs and a JSON summary
(chip_work/chip_smoke_summary.json) go under chip_work/, which .gitignore
lists.
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "chip_work", "smoke")
SUMMARY = os.path.join(ROOT, "chip_work", "chip_smoke_summary.json")
GOLDEN = os.path.join(ROOT, "tests", "goldens", "amira_results_seed7.tsv")

# (W, Lq, B): the CPU tests' shapes, the last planting the DP kernel's edge
# cases; the production shapes, timed: the 50k-read main path's two large
# sw_dp launches and the shape the earlier kernels were timed at. The kernels
# JSON line reports MAIN_SHAPE, the main path's largest launch.
TEST_SHAPES = [(64, 128, 24), (128, 256, 9), (256, 192, 37)]
EDGE_SHAPE = (256, 192, 37)
PROD_SHAPES = [(256, 1024, 980), (256, 1024, 490), (256, 2048, 512)]
MAIN_SHAPE = (256, 1024, 980)
SWEEP_B = (128, 512, 1024, 2048)  # sw_dp at Lq=2048, W=256
# (W, Lq, B) of the random-byte traceback checks: the CPU test's and one near
# the main path's largest launch
RANDOM_SHAPES = [(64, 96, 40), (256, 192, 24), (256, 1024, 980)]

# Bounds. H100 SXM: HBM3 at 3.35 TB/s (NVIDIA's data sheet); int32 issue of
# 132 SMs x 64 int32 lanes x 1.98 GHz boost clock (Hopper white paper).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations per live cell that sw_dp's recurrence needs, counted
# from the plain version (sw_dp_reference), not from any kernel: each
# quantity once per cell, a DPX max with its >= predicate (or an add-max) as
# one. Reference and match tests, the score 3; the max of the previous
# cell's five states with its nested >= predicates 4, and the code they
# pick 4 (the previous row's value and state, which the plain version
# computes again as this row's diagonal input); M = max(max(prev, 0) +
# score, 0) 1; M's predecessor code, kept where M > 0 and prev > 0, 3;
# M - OPEN and M - OPEN2 (this row's deletions, the next row's insertions)
# 2; I and I2, the extend candidate and the max with its flag, 2 each; D and
# D2, the same and the NEG clamp, 3 each; the masks outside the reference
# 5; the traceback byte's five flags 5; the row maximum at its first lane 2.
SW_DP_OPS_PER_CELL = 39
# int32 operations per step of sw_traceback's walk, counted from the loop of
# the first (one thread per job) kernel and kept fixed across versions
SW_TB_OPS_PER_STEP = 20


def fail(msg: str):
    sys.stderr.write(f"chip_smoke: FAILED: {msg}\n")
    sys.exit(1)


def sw_inputs(W, Lq, B, seed, device, min_len=8, edges=False):
    """A batch of alignment jobs laid out as the aligner lays them out:
    noisy query/reference pairs (2% substitutions, 2% indels), every fifth
    pair unrelated, band diagonals near the aligner's placement (-W/2) or
    random, and three padded (empty) lanes. `edges` plants query lengths 1,
    W/32 - 1 and 3 and two strongly negative diagonals."""
    import numpy as np
    import torch
    from synthetic import mutate_fast

    rng = np.random.RandomState(seed)
    P = W + Lq
    rlen = 2 * Lq + 2 * W + 2 * Lq
    qs = np.full((B, Lq), 4, np.uint8)
    rs = np.full((B, rlen), 4, np.uint8)
    qlens = np.zeros(B, np.int32)
    dlos = np.zeros(B, np.int32)
    for b in range(B - 3):
        n = rng.randint(min_len, Lq + 1)
        q = rng.randint(0, 4, size=n).astype(np.uint8)
        if b % 5 == 4:
            r = rng.randint(0, 4, size=n).astype(np.uint8)
        else:
            r = mutate_fast(rng, q, sub=0.02, indel=0.02)[: Lq + W]
        qs[b, :n] = q
        rs[b, P : P + len(r)] = r
        qlens[b] = n
        if b % 7 == 6:
            dlos[b] = rng.randint(-(Lq - 1), max(len(r) - 1, 1))
        else:
            dlos[b] = -W // 2 + rng.randint(-16, 17)
    if edges:
        for b, n in enumerate((1, W // 32 - 1, 3)):
            qs[b, n:] = 4
            qlens[b] = n
        dlos[3], dlos[4] = -(Lq - 1), -(Lq - W // 2)
    return [torch.from_numpy(a).to(device) for a in (qs, rs, qlens, dlos)]


def random_band(W, Lq, B, seed):
    """Random traceback bytes and walk starts, as numpy arrays (tb (B, Lq,
    W) uint8; best, bi, bw, bs, dlos (B,) int32): predecessor codes skewed
    to 1-5, each extend bit set with probability 13/16, the match bit with
    1/2. Such walks run long gap stretches, reach clamped lanes and the step
    cap, which walks over DP-made bands rarely do. Some jobs are done at
    once (best <= 0 or bi = -1) and some start outside the band."""
    import numpy as np

    rng = np.random.RandomState(seed)
    pred_of = np.repeat(np.arange(8, dtype=np.uint8), [8, 96, 32, 32, 32, 32, 12, 12])
    tb = pred_of[rng.randint(0, 256, size=(B, Lq, W), dtype=np.uint8)]
    for bit in range(3, 8):
        odds = 128 if bit == 7 else 208
        tb |= (rng.randint(0, 256, size=tb.shape, dtype=np.uint8) < odds).astype(np.uint8) << bit
    best = rng.randint(-2, 40, size=B).astype(np.int32)
    bi = rng.randint(-1, Lq, size=B).astype(np.int32)
    bw = rng.randint(0, W, size=B).astype(np.int32)
    bw[0::13], bw[1::13] = -3, W + 2
    bs = rng.randint(0, 5, size=B).astype(np.int32)
    dlos = rng.randint(-Lq, Lq, size=B).astype(np.int32)
    return tb, best, bi, bw, bs, dlos


def max_abs_diff(pairs) -> int:
    import torch

    return max(
        int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
        for a, b in pairs
    )


def cuda_ms(fn, reps, warm=1) -> float:
    """Mean milliseconds per call between CUDA events, after warm-up."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_, ops):
    """Least time on the card for moving `bytes_` and issuing `ops` int32
    operations: (ms, "bytes" or "operations", kind)."""
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    return (o_ms, "operations", "int32_issue") if o_ms >= b_ms else (b_ms, "bytes", "bytes")


def dp_bound(qlens, W):
    """Live cells of a sw_dp call and its bound: each live query byte and
    reference-window byte read once, one traceback byte written per live
    cell, six int32 per job; SW_DP_OPS_PER_CELL per live cell."""
    live = int(qlens.sum())
    B = qlens.numel()
    window = live + (W - 1) * int((qlens > 0).sum())
    cells = live * W
    return cells, bound(live + window + cells + 24 * B, cells * SW_DP_OPS_PER_CELL)


def tb_bound(packed, n_steps):
    """sw_traceback's bound: one traceback byte read per step of the walks,
    the packed ops written, eight int32 per job; SW_TB_OPS_PER_STEP per
    step."""
    steps = int(n_steps.sum())
    return bound(steps + packed.numel() + 32 * n_steps.numel(), steps * SW_TB_OPS_PER_STEP)


def dp_diff(got, ref, qlens) -> int:
    """Largest difference between two sw_dp results (tb on live rows,
    best, bi, bw, bs)."""
    import torch

    live = torch.arange(got[0].shape[1], device=qlens.device)[None, :] < qlens[:, None].long()
    return max_abs_diff([(got[0][live], ref[0][live])] + list(zip(got[1:], ref[1:])))


def check_kernels(device):
    """Phase 2: each kernel against its plain version on the same inputs at
    every shape, timed at PROD_SHAPES; then the sw_dp sweep. Returns
    ({(W, Lq, B): {kernel name: its JSON fields measured there}}, sweep
    rows)."""
    from amira_tpu_torch.ops import sw_batch
    from amira_tpu_torch.ops.align import _unpack_cigar

    errs = {"sw_dp": 0, "sw_traceback": 0}
    timed = {}
    for W, Lq, B in TEST_SHAPES + PROD_SHAPES:
        prod = (W, Lq, B) in PROD_SHAPES
        qs, rs, qlens, dlos = sw_inputs(
            W, Lq, B, seed=Lq + B, device=device, min_len=3 * Lq // 4 if prod else 8,
            edges=(W, Lq, B) == EDGE_SHAPE,
        )
        tb, best, bi, bw, bs = sw_batch.sw_dp(qs, rs, qlens, dlos, W)
        r_tb, r_best, r_bi, r_bw, r_bs = sw_batch.sw_dp_reference(qs, rs, qlens, dlos, W)
        # traceback rows at or past a job's query length are unspecified
        dp_err = dp_diff((tb, best, bi, bw, bs), (r_tb, r_best, r_bi, r_bw, r_bs), qlens)
        del r_tb
        sw_batch.traceback_restages(reset=True)
        tb_out = sw_batch.sw_traceback(tb, best, bi, bw, bs, dlos, W)
        restages = sw_batch.traceback_restages(reset=True)
        r_tb_out = sw_batch.sw_traceback_reference(tb, best, bi, bw, bs, dlos, W)
        tb_err = max_abs_diff(list(zip(tb_out, r_tb_out)))
        fused = sw_batch.sw_cigar(qs, rs, qlens, dlos, W)
        r_fused = sw_batch.sw_cigar_reference(qs, rs, qlens, dlos, W)
        fused_err = max_abs_diff(list(zip(fused, r_fused)))
        packed, n_steps = fused[0].cpu().numpy(), fused[1].cpu().numpy()
        r_packed, r_n = r_fused[0].cpu().numpy(), r_fused[1].cpu().numpy()
        n_cigars = 0
        for j in range(B):
            a, b = _unpack_cigar(packed[j], int(n_steps[j])), _unpack_cigar(r_packed[j], int(r_n[j]))
            if a != b:
                fail(f"sw_cigar: decoded CIGAR of job {j} differs at {(W, Lq, B)}")
            n_cigars += bool(a)
        mapped = int((best > 0).sum())
        print(
            f"phase 2 kernels (W={W}, Lq={Lq}, B={B}): sw_dp max_abs_err {dp_err}, "
            f"sw_traceback max_abs_err {tb_err}, fused max_abs_err {fused_err}, "
            f"{mapped} jobs with a positive score, {n_cigars} CIGARs equal"
        )
        if dp_err or tb_err or fused_err:
            fail(f"kernel output differs from its plain version at {(W, Lq, B)}")
        if mapped < B // 2:
            fail(f"too few aligned jobs ({mapped}) at {(W, Lq, B)}")
        errs["sw_dp"] = max(errs["sw_dp"], dp_err, fused_err)
        errs["sw_traceback"] = max(errs["sw_traceback"], tb_err, fused_err)
        del fused, r_fused, tb_out, r_tb_out, tb
        if prod:
            walked = int((r_n > 0).sum())
            print(
                f"phase 2 walks (B={B}, Lq={Lq}, W={W}): {walked} walks, longest "
                f"{int(r_n.max())} steps, {int(r_n.sum())} steps in all, "
                f"{restages} re-stages ({restages / max(walked, 1):.4f} per walk)"
            )
            timed[(W, Lq, B)] = time_kernels(qs, rs, qlens, dlos, W)
            timed[(W, Lq, B)]["sw_traceback"]["restages"] = restages
    check_random_walks(device)
    for fields in timed.values():
        for name, f in fields.items():
            f["max_abs_err"] = errs[name]
    return timed, sweep_dp(device)


def check_random_walks(device):
    """sw_traceback against its plain version, exactly, on random_band at
    RANDOM_SHAPES."""
    import torch

    from amira_tpu_torch.ops import sw_batch

    for W, Lq, B in RANDOM_SHAPES:
        args = [torch.from_numpy(a).to(device) for a in random_band(W, Lq, B, seed=W + Lq + B)]
        got = sw_batch.sw_traceback(*args, W)
        ref = sw_batch.sw_traceback_reference(*args, W)
        err = max_abs_diff(list(zip(got, ref)))
        n = ref[1]
        capped = int((n == sw_batch.tb_steps(Lq, W)).sum())
        print(
            f"phase 2 random walks (W={W}, Lq={Lq}, B={B}): sw_traceback max_abs_err {err}, "
            f"{int((n > 0).sum())} walks, longest {int(n.max())} steps, {capped} at the step cap"
        )
        if err:
            fail(f"sw_traceback differs from its plain version on random bytes at {(W, Lq, B)}")


def traceback_after_dp_ms(traceback, qs, rs, qlens, dlos, W, reps=20) -> float:
    """Mean milliseconds of `traceback(tb, best, bi, bw, bs, dlos, W)` as
    the main path calls it: each launch right after a fresh sw_dp on the
    same inputs (so the band is the one the DP just wrote), between its own
    pair of CUDA events; one warm-up launch first."""
    import torch

    from amira_tpu_torch.ops import sw_batch

    events = []
    for _ in range(reps + 1):
        tb, best, bi, bw, bs = sw_batch.sw_dp(qs, rs, qlens, dlos, W)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        traceback(tb, best, bi, bw, bs, dlos, W)
        end.record()
        events.append((start, end))
        del tb
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events[1:]) / reps


def time_kernels(qs, rs, qlens, dlos, W):
    """CUDA-event times of both kernels and their plain versions on one
    batch, with each kernel's bound and the longest walk; prints one line
    per kernel."""
    from amira_tpu_torch.ops import sw_batch

    B, Lq = qs.shape
    tb, best, bi, bw, bs = sw_batch.sw_dp(qs, rs, qlens, dlos, W)
    packed, n_steps, _, _ = sw_batch.sw_traceback(tb, best, bi, bw, bs, dlos, W)
    longest = int(n_steps.max())
    times = {
        "sw_dp": (
            cuda_ms(lambda: sw_batch.sw_dp(qs, rs, qlens, dlos, W), reps=20),
            cuda_ms(lambda: sw_batch.sw_dp_reference(qs, rs, qlens, dlos, W), reps=2),
            dp_bound(qlens, W)[1],
        ),
        "sw_traceback": (
            traceback_after_dp_ms(sw_batch.sw_traceback, qs, rs, qlens, dlos, W),
            cuda_ms(
                lambda: sw_batch.sw_traceback_reference(tb, best, bi, bw, bs, dlos, W),
                reps=2,
            ),
            tb_bound(packed, n_steps),
        ),
    }
    del tb
    out = {}
    for name, (ms, plain_ms, (bound_ms, bound_by, kind)) in times.items():
        pct = 100.0 * bound_ms / ms
        print(
            f"phase 2 time at (B={B}, Lq={Lq}, W={W}): {name} kernel {ms:.4f} ms, "
            f"plain PyTorch {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({kind}), "
            f"{pct:.1f} % of bound"
        )
        out[name] = {
            "shape": {"B": B, "Lq": Lq, "W": W}, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_kind": kind,
            "roofline_pct": pct, "library_ms": None, "longest_walk": longest,
        }
    ns = times["sw_traceback"][0] * 1e6 / max(longest, 1)
    print(
        f"phase 2 walk at (B={B}, Lq={Lq}, W={W}): longest walk {longest} steps, "
        f"sw_traceback {ns:.1f} ns per step of it"
    )
    out["sw_traceback"]["ns_per_step"] = ns
    return out


def sweep_dp(device):
    """sw_dp at Lq=2048, W=256 over SWEEP_B, exact against the plain
    version at every point; two passes of 10 launches each."""
    from amira_tpu_torch.ops import sw_batch

    W, Lq = 256, 2048
    rows = []
    for B in SWEEP_B:
        qs, rs, qlens, dlos = sw_inputs(W, Lq, B, seed=1, device=device, min_len=3 * Lq // 4)
        err = dp_diff(
            sw_batch.sw_dp(qs, rs, qlens, dlos, W),
            sw_batch.sw_dp_reference(qs, rs, qlens, dlos, W), qlens,
        )
        if err:
            fail(f"sw_dp differs from its plain version at B={B} (max_abs_err {err})")
        ms = [cuda_ms(lambda: sw_batch.sw_dp(qs, rs, qlens, dlos, W), reps=10) for _ in range(2)]
        mean = sum(ms) / len(ms)
        cells, (bound_ms, _, kind) = dp_bound(qlens, W)
        rows.append({
            "B": B, "Lq": Lq, "W": W, "cells": cells, "ms": ms, "bound_ms": bound_ms,
            "gcells": cells / mean / 1e6, "roofline_pct": 100.0 * bound_ms / mean,
            "max_abs_err": err,
        })
        print(
            f"phase 2 sweep (B={B}, Lq={Lq}, W={W}, {cells} live cells): sw_dp "
            f"{' / '.join(f'{m:.4f}' for m in ms)} ms, {cells / mean / 1e6:.1f} Gcell/s, "
            f"{100.0 * bound_ms / mean:.1f} % of its {bound_ms:.4f} ms bound ({kind})"
        )
    return rows


def cli_args(files, outdir, device):
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
        "--device", device,
    ]


def run_cli(argv):
    from amira_tpu_torch.__main__ import main

    try:
        main(argv)
    except SystemExit as e:
        if e.code not in (None, 0):
            fail(f"the CLI exited with {e.code}")


def check_golden(device):
    """Phase 3: the committed golden TSV, byte for byte."""
    from synthetic import make_isolate

    d = os.path.join(WORK, "golden")
    files = make_isolate(
        os.path.join(d, "data"), seed=7, n_reads=90, amr_genes=("amrX", "amrY"),
        layout=["geneA", "geneB", "amrX", "geneC", "geneD", "amrY", "geneE", "geneF"],
    )
    out = os.path.join(d, "out")
    t0 = time.time()
    run_cli(cli_args(files, out, device))
    with open(os.path.join(out, "amira_results.tsv")) as f, open(GOLDEN) as g:
        if f.read() != g.read():
            fail("amira_results.tsv of the seed-7 isolate differs from the golden")
    print(f"phase 3 golden: amira_results.tsv equals the committed golden ({time.time() - t0:.1f} s)")


def scale_layout():
    """The 4,003-slot genome of scale_run.py: amrX at two loci, amrY once."""
    layout = []
    for i in range(4000):
        layout.append(f"gene{i}")
        if i in (500, 2900):
            layout.append("amrX")
        if i == 1700:
            layout.append("amrY")
    return layout


def run_main_path(n_reads, device):
    """Phase 4: the main path at a real isolate size. Returns its summary."""
    import torch

    from amira_tpu_torch.ops import graph_tables, kmer, sw_batch
    from synthetic import make_isolate

    d = os.path.join(WORK, "scale")
    t0 = time.time()
    files = make_isolate(
        os.path.join(d, "data"), n_reads=n_reads, seed=17, layout=scale_layout(),
        amr_genes=("amrX", "amrY"), genes_per_read=(10, 20), gene_len=400,
        fast=True, call_noise=0.05,
    )
    gen_s = time.time() - t0
    print(f"phase 4 generated {n_reads} reads in {gen_s:.1f} s (host, not timed below)")
    out = os.path.join(d, "out")
    for counts in (sw_batch.LAUNCHES, graph_tables.DEVICE_RUNS, kmer.DENSE_TABLES):
        for key in counts:
            counts[key] = 0
    sw_batch.DP_SHAPES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    run_cli(cli_args(files, out, device))
    torch.cuda.synchronize()
    wall_s = time.time() - t0
    launches = dict(sw_batch.LAUNCHES)
    dp_shapes = [[B, Lq, n] for (B, Lq), n in sw_batch.DP_SHAPES.items()]
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out, "phase_timings.json")) as f:
        phases = json.load(f)
    for p in phases:
        print(f"phase 4 timing: {p['phase']:<24s} {p['seconds']:9.3f} s")
    print(
        f"phase 4 main path: {wall_s:.1f} s wall, peak device memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB), launches {launches}, "
        f"window-hash runs {graph_tables.DEVICE_RUNS}, dense tables {kmer.DENSE_TABLES}"
    )
    print(f"phase 4 sw_dp launches by shape (B, Lq, launches): {dp_shapes}")
    with open(os.path.join(out, "amira_results.tsv")) as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    for r in rows:
        print(
            f"phase 4 result: {r['Determinant name']} {r['Amira allele']} "
            f"{r['Closest reference']} identity {r['Identity (%)']} "
            f"copy number {r['Approximate cellular copy number']}"
        )
    names = sorted(r["Determinant name"] for r in rows)
    if names != ["amrX", "amrX", "amrY"]:
        fail(f"expected amrX x2 + amrY, got {names}")
    for r in rows:
        if r["Closest reference"] != "NG001":
            fail(f"{r['Amira allele']}: closest reference {r['Closest reference']}")
        if float(r["Identity (%)"].split("/")[0]) < 99.0:
            fail(f"{r['Amira allele']}: identity {r['Identity (%)']}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if graph_tables.DEVICE_RUNS["cuda"] <= 0:
        fail("no graph build hashed its windows on the card")
    if kmer.DENSE_TABLES["cuda"] <= 0:
        fail("the dense k-mer table was not allocated on the card")
    return {
        "reads": n_reads,
        "generate_seconds": gen_s,
        "wall_seconds": wall_s,
        "peak_device_memory_bytes": peak,
        "launches": launches,
        "dp_shapes": dp_shapes,
        "window_hash_runs": dict(graph_tables.DEVICE_RUNS),
        "dense_tables": dict(kmer.DENSE_TABLES),
        "phases": phases,
        "rows": rows,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reads", type=int, default=50_000, help="reads of the phase-4 isolate")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from amira_tpu_torch.ops import sw_batch

    device = "cuda"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    shutil.rmtree(WORK, ignore_errors=True)
    t0 = time.time()
    lib = sw_batch.build()
    print(f"phase 1 build: {os.path.relpath(lib, ROOT)} in {time.time() - t0:.2f} s")
    with open(os.path.join(os.path.dirname(lib), "sw_batch_ptxas.txt")) as f:
        for line in f:
            if "Used" in line or "spill" in line:
                print(f"phase 1 ptxas: {line.strip()}")
    timed, sweep = check_kernels(device)
    check_golden(device)
    summary = run_main_path(args.reads, device)

    kernels = [
        {
            "name": "sw_dp",
            "route": "cuda",
            "source": "amira_tpu_torch/csrc/sw_batch.cu",
            "replaces": "amira_tpu/ops/pallas_sw_batch.py:51",
            "launches": summary["launches"]["sw_dp"],
            **timed[MAIN_SHAPE]["sw_dp"],
        },
        {
            "name": "sw_traceback",
            "route": "cuda",
            "source": "amira_tpu_torch/csrc/sw_batch.cu",
            "replaces": "amira_tpu/ops/align.py:390",
            "launches": summary["launches"]["sw_traceback"],
            **timed[MAIN_SHAPE]["sw_traceback"],
        },
    ]
    os.makedirs(os.path.dirname(SUMMARY), exist_ok=True)
    with open(SUMMARY, "w") as f:
        json.dump(
            {"card": card, "kernels": kernels, "timed": list(timed.values()), "sweep": sweep,
             "main_path": summary}, f, indent=1,
        )
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))


if __name__ == "__main__":
    main()
