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
   noise, seed 17, --reads reads (default 50,000, about 300 Mbp). The
   isolate is generated in a child process with PYTHONHASHSEED=0, started
   before phase 1's build so that it overlaps phases 1-3, and the SHA-256
   of its decompressed FASTQ is printed: every call runs on the same bases.
   The CLI runs with --device cuda; the result must be two amrX rows and
   one amrY row matching allele NG001 at >= 99% identity, every kernel of
   the path must have launched, the large graph build must have hashed its
   windows on the card and the dense k-mer table must have lived there.
5. The single-isolate features beyond the main path, with --device cuda:
   a. the kernels' W = 512 instances (the path assembly's polishing band):
      ptxas's registers and spills, both kernels exact against their plain
      versions at an edge batch (512, 192, 37) and on random traceback
      bytes (512, 192, 24), and, after 5c, exact and timed at the largest
      (B, Lq) that 5c launched at W = 512;
   b. the SAM route (--pandoraSam, --pandoraConsensus) on the first
      SAM_READS reads of the phase-4 isolate, with a consensus of all its
      4,002 gene sequences: its consensus QC aligns every read against
      every gene on the card. Prints per-phase seconds, the wall, peak
      device memory, the QC's jobs and the seconds of its seeding and its
      alignment, the kernel wrappers' spans on the stream, sw_dp launches
      by (B, Lq, W), and the seeding of the first read timed against a
      per-gene loop; the rows must be phase 4's;
   c. --assemble-paths' assembly (`assemble_full_length_paths`) of phase
      4's path reads on the card: every path must give a contig;
   d. --assembly, --meta and --promoter-mutations on their small isolates
      must write the committed goldens (tests/goldens/, written by
      amira_tpu) byte for byte, and --assemble-paths on the seed-7 isolate
      the same path FASTAs as the assembly on the CPU.
6. Several isolates and several shards, with --device cuda:
   a. the batch driver (`amira_tpu_torch.batch.run_batch`) on a manifest of
      BATCH_ISOLATES copies of phase 4's isolate, with 1 and with 4 workers
      (four CUDA streams on the one card): every amira_results.tsv must be
      phase 4's byte for byte and every isolate must have launched both
      kernels. Prints each run's wall, isolates per hour, peak device
      memory and the host's peak resident set;
   b. the distributed graph build of --dist-build
      (`parallel/distgraph.distributed_graph_build`) on phase 4's initial
      gene calls at k = 3, over DIST_SHARDS shards of the card and over the
      CPU: the graphs must be equal. Prints the seconds of both and of the
      cached single-device build. (With one card the CLI never takes this
      path, so this phase is what drives it there.)
   c. the same build on a ("data", "table") mesh of 2 x 2 shards of the
      card and on a ("host", "data", "table") mesh of 2 x 2 x 2: both
      graphs must equal 6b's; prints each mesh's first and second call;
   d. the bin-sharded k-mer table (`make_distributed_kmer_step`, the
      stream split as `distributed_kmer_count` splits it) at k = 15 over
      phase 4's reads on DIST_SHARDS shards of the card, each shard's bins
      equal (torch.equal, on the card) to KmerCounter's dense table of the
      same reads; prints the host packing, the step's and the counter's
      seconds and peak device memory;
   e. two processes (`parallel.multiproc`, gloo, four shards of the card
      each): the ("host", "data", "table") = (2, 2, 2) count step on the
      initial calls with "host" on the process boundary, and the k-mer step
      at k = 15 on the first SAM_READS reads with its bins over all eight
      shards, both held to the same steps in this process; prints the wall
      and the bytes that crossed the process boundary;
   f. `graft_entry.entry()` on the card, `dryrun_multichip` at 2, 4 and 8
      shards of it, and `scaling_report`'s rows over the visible devices.
7. The JAX package's last two device paths, on the card:
   a. the sorted k-mer counter: the first reads of phase 4's isolate at
      about 2^16, 2^20 and just under 2^24 codes, counted at k = 15 by
      `KmerCounter.from_sequences` (which must take the sorted counter)
      and held to the dense table of the same reads: k-mers, counts,
      histogram, cutoff, the depth of `estimate_overall_read_depth` and
      `estimate_depth_for_reads` on each AMR path's reads. Prints n_codes,
      the median of 3 timed runs of each counter and their peak device
      memory. Phase 3's golden run must have counted on the sorted
      counter, phase 4 on the dense table;
   b. the graph build without a cache (eager, its tables grouped on the
      card): phase 4's initial calls at k = 3 (first and second call),
      and the first UNCACHED_READS reads at k = 5 and 7, each equal in
      full to the same build on the CPU; `build_and_correct_graph` without
      a cache on phase 3's isolate gives the CPU's corrected calls.

The next-to-last lines are the card line and one JSON object describing
each kernel; the last line is {"ok": true, "device": {...}}. Any failed
phase exits non-zero without that line, as does a machine without CUDA.
The kernels JSON line reports each kernel at the main path's largest
launch, (B, Lq, W) = (980, 1024, 256), with its launches on the main path
(phase 4), on the SAM route (5b), in the path assembly (5c) and in each
batch (6a, summed over its isolates), and its W = 512 checks and time
(5a). Data, outputs and a JSON summary
(chip_work/chip_smoke_summary.json) go under chip_work/, which .gitignore
lists.
"""

from __future__ import annotations

import argparse
import atexit
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
# (W, Lq, B) of phase 5a's checks of the W = 512 instances (the assembly's
# polishing band): the edge batch and random traceback bytes
W512_EDGE_SHAPE = (512, 192, 37)
W512_RANDOM_SHAPE = (512, 192, 24)
# reads of the phase-4 isolate that phase 5b's SAM route takes, and those
# it seeds both ways (the per-gene loop costs seconds per read). The route
# costs about 5-6 ms of host time a read on the H100's host (PERF.md): all
# 50,000 reads took this script to 917 s of its 1,200. It takes the first
# 10,000 (20,000 before phases 6a and 6b, which add about 200 s), so that
# the script ends near half its limit, with room for the host's spread.
SAM_READS = 10_000
SEEDING_READS = 1
# phase 6a: a batch of this many copies of the phase-4 isolate, run once per
# worker count (BASELINE config 4 is 32 isolates per host; four at a time
# fill four streams on the card)
BATCH_ISOLATES = 4
BATCH_WORKERS = (1, 4)
# phases 6b and 6d: shards of the distributed build and k-mer table on the card
DIST_SHARDS = 4
KMER_K = 15  # the copy-number estimate's k (phases 6d, 6e, 7a; multiproc's)
# phase 7a's reads come from the first SORTED_READS of phase 4's isolate
# (about 2,700 of them fill 2^24 codes); phase 7b builds the first
# UNCACHED_READS at k = 5 and 7
SORTED_READS = 4_000
UNCACHED_READS = 5_000

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


def timed_once(fn, *args):
    """(*fn(*args), its milliseconds between CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn(*args)
    end.record()
    torch.cuda.synchronize()
    return (*out, start.elapsed_time(end))


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


def check_shape(W, Lq, B, device, label, min_len=8, edges=False):
    """Both kernels (apart, and fused with their CIGARs decoded) against
    their plain versions on one sw_inputs batch, exactly; fails on any
    difference. Returns (inputs, {kernel name: max_abs_err}, restages,
    the plain walk's step counts, {kernel name: ms of its one plain call
    here, between CUDA events})."""
    from amira_tpu_torch.ops import sw_batch
    from amira_tpu_torch.ops.align import _unpack_cigar

    qs, rs, qlens, dlos = sw_inputs(
        W, Lq, B, seed=Lq + B, device=device, min_len=min_len, edges=edges
    )
    plain_ms = {}
    tb, best, bi, bw, bs = sw_batch.sw_dp(qs, rs, qlens, dlos, W)
    r_tb, r_best, r_bi, r_bw, r_bs, plain_ms["sw_dp"] = timed_once(
        sw_batch.sw_dp_reference, qs, rs, qlens, dlos, W
    )
    # traceback rows at or past a job's query length are unspecified
    dp_err = dp_diff((tb, best, bi, bw, bs), (r_tb, r_best, r_bi, r_bw, r_bs), qlens)
    del r_tb
    sw_batch.traceback_restages(reset=True)
    tb_out = sw_batch.sw_traceback(tb, best, bi, bw, bs, dlos, W)
    restages = sw_batch.traceback_restages(reset=True)
    *r_tb_out, plain_ms["sw_traceback"] = timed_once(
        sw_batch.sw_traceback_reference, tb, best, bi, bw, bs, dlos, W
    )
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
        f"{label} kernels (W={W}, Lq={Lq}, B={B}): sw_dp max_abs_err {dp_err}, "
        f"sw_traceback max_abs_err {tb_err}, fused max_abs_err {fused_err}, "
        f"{mapped} jobs with a positive score, {n_cigars} CIGARs equal"
    )
    if dp_err or tb_err or fused_err:
        fail(f"kernel output differs from its plain version at {(W, Lq, B)}")
    if mapped < B // 2:
        fail(f"too few aligned jobs ({mapped}) at {(W, Lq, B)}")
    errs = {"sw_dp": max(dp_err, fused_err), "sw_traceback": max(tb_err, fused_err)}
    return (qs, rs, qlens, dlos), errs, restages, r_n, plain_ms


def check_kernels(device):
    """Phase 2: each kernel against its plain version on the same inputs at
    every shape, timed at PROD_SHAPES; then the sw_dp sweep. Returns
    ({(W, Lq, B): {kernel name: its JSON fields measured there}}, sweep
    rows)."""
    errs = {"sw_dp": 0, "sw_traceback": 0}
    timed = {}
    for W, Lq, B in TEST_SHAPES + PROD_SHAPES:
        prod = (W, Lq, B) in PROD_SHAPES
        inputs, shape_errs, restages, r_n, _ = check_shape(
            W, Lq, B, device, "phase 2", min_len=3 * Lq // 4 if prod else 8,
            edges=(W, Lq, B) == EDGE_SHAPE,
        )
        for name, e in shape_errs.items():
            errs[name] = max(errs[name], e)
        if prod:
            walked = int((r_n > 0).sum())
            print(
                f"phase 2 walks (B={B}, Lq={Lq}, W={W}): {walked} walks, longest "
                f"{int(r_n.max())} steps, {int(r_n.sum())} steps in all, "
                f"{restages} re-stages ({restages / max(walked, 1):.4f} per walk)"
            )
            timed[(W, Lq, B)] = time_kernels(*inputs, W)
            timed[(W, Lq, B)]["sw_traceback"]["restages"] = restages
    check_random_walks(device, RANDOM_SHAPES, "phase 2")
    for fields in timed.values():
        for name, f in fields.items():
            f["max_abs_err"] = errs[name]
    return timed, sweep_dp(device)


def check_random_walks(device, shapes, label):
    """sw_traceback against its plain version, exactly, on random_band at
    `shapes`; returns the largest difference (0, or it fails)."""
    import torch

    from amira_tpu_torch.ops import sw_batch

    for W, Lq, B in shapes:
        args = [torch.from_numpy(a).to(device) for a in random_band(W, Lq, B, seed=W + Lq + B)]
        got = sw_batch.sw_traceback(*args, W)
        ref = sw_batch.sw_traceback_reference(*args, W)
        err = max_abs_diff(list(zip(got, ref)))
        n = ref[1]
        capped = int((n == sw_batch.tb_steps(Lq, W)).sum())
        print(
            f"{label} random walks (W={W}, Lq={Lq}, B={B}): sw_traceback max_abs_err {err}, "
            f"{int((n > 0).sum())} walks, longest {int(n.max())} steps, {capped} at the step cap"
        )
        if err:
            fail(f"sw_traceback differs from its plain version on random bytes at {(W, Lq, B)}")
    return 0


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


def time_kernels(qs, rs, qlens, dlos, W, label="phase 2", plain_ms=None):
    """CUDA-event times of both kernels and their plain versions (two calls
    each after a warm-up call, unless `plain_ms` gives their times) on one
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
            plain_ms["sw_dp"] if plain_ms else cuda_ms(
                lambda: sw_batch.sw_dp_reference(qs, rs, qlens, dlos, W), reps=2
            ),
            dp_bound(qlens, W)[1],
        ),
        "sw_traceback": (
            traceback_after_dp_ms(sw_batch.sw_traceback, qs, rs, qlens, dlos, W),
            plain_ms["sw_traceback"] if plain_ms else cuda_ms(
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
            f"{label} time at (B={B}, Lq={Lq}, W={W}): {name} kernel {ms:.4f} ms, "
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
        f"{label} walk at (B={B}, Lq={Lq}, W={W}): longest walk {longest} steps, "
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


# the small isolates of the modes (tests/test_modes.py, test_promoters.py)
# and the goldens amira_tpu writes for them
MODE_GOLDENS = {
    "assembly": "amira_results_assembly_seed31.tsv",
    "meta": "amira_results_meta_seed32.tsv",
    "promoters": "amira_results_promoters_seed21.tsv",
}


def mode_files(mode, d):
    """Generates a mode's small isolate under `d` (see `mode_argv`) and
    returns its input paths."""
    import gzip

    from synthetic import make_isolate

    data = os.path.join(d, "data")
    seed, n_reads, kwargs = {
        "assembly": (31, 20, dict(sub=0.0, indel=0.0)),
        "meta": (32, 40, {}),
        "promoters": (21, 80, {}),
        "debug": (33, 40, {}),
    }[mode]
    files = make_isolate(data, seed=seed, n_reads=n_reads, **kwargs)
    if mode == "assembly":
        files["assembly"] = os.path.join(data, "assembly.fa")
        with gzip.open(files["fastq"], "rt") as fh, open(files["assembly"], "w") as out:
            while True:
                h = fh.readline()
                if not h:
                    break
                seq = fh.readline().strip()
                fh.readline()
                fh.readline()
                out.write(f">{h[1:].strip()}\n{seq}\n")
    if mode == "promoters":
        gene = files["gene_seqs"]["amrX"]
        alt = next(c for c in "ACGT" if c != gene[50])
        with open(files["amr_fasta"], "a") as fh:
            fh.write(f"\n>amrX_promoter;amrX.NG003.1\n{gene[:50]}{alt}{gene[51:]}")
    return {k: v for k, v in files.items() if isinstance(v, str)}


def mode_argv(mode, d):
    """CLI arguments, all but --output and --device, of a mode's small
    isolate, generated under `d`: "assembly" (seed 31, the reads written as
    an assembly FASTA), "meta" (seed 32), "promoters" (seed 21, with an amrX
    promoter reference one SNP away from the reads) or "debug" (seed 33,
    with --debug and --output-component-fastqs). The isolate is generated
    in a child process with PYTHONHASHSEED=0: make_isolate draws the gene
    sequences in the order of a set of names, which follows string hashing,
    and the promoter row names the SNP's bases."""
    env = dict(os.environ, PYTHONHASHSEED="0")
    env["PYTHONPATH"] = os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])
    code = f"import chip_smoke, json; print(json.dumps(chip_smoke.mode_files({mode!r}, {d!r})))"
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, check=True,
    )
    files = json.loads(out.stdout.splitlines()[-1])
    reads = ["--assembly", files["assembly"]] if mode == "assembly" else ["--reads", files["fastq"]]
    extra = {
        "assembly": [], "meta": ["--meta"], "promoters": ["--promoter-mutations"],
        "debug": ["--debug", "--output-component-fastqs"],
    }[mode]
    return [
        "--pandoraJSON", files["calls"],
        "--gene-positions", files["positions"],
        *reads,
        "--species", "Escherichia_coli",
        "--amr-fasta", files["amr_fasta"],
        "--amr-calls", files["amr_calls"],
        "--core-genes", files["core_genes"],
        "--plasmid-genes", files["plasmid_genes"],
        "--quiet",
        *extra,
    ]


def run_cli(argv):
    from amira_tpu_torch.__main__ import main

    try:
        main(argv)
    except SystemExit as e:
        if e.code not in (None, 0):
            fail(f"the CLI exited with {e.code}")


def check_golden(device):
    """Phase 3: the committed golden TSV, byte for byte. Returns the
    isolate's files and the k-mer tables its copy-number count made, by
    counter and device type (phase 7a checks them)."""
    from amira_tpu_torch.ops import kmer
    from synthetic import make_isolate

    d = os.path.join(WORK, "golden")
    files = make_isolate(
        os.path.join(d, "data"), seed=7, n_reads=90, amr_genes=("amrX", "amrY"),
        layout=["geneA", "geneB", "amrX", "geneC", "geneD", "amrY", "geneE", "geneF"],
    )
    out = os.path.join(d, "out")
    for counts in (kmer.SORTED_TABLES, kmer.DENSE_TABLES):
        for key in counts:
            counts[key] = 0
    t0 = time.time()
    run_cli(cli_args(files, out, device))
    with open(os.path.join(out, "amira_results.tsv")) as f, open(GOLDEN) as g:
        if f.read() != g.read():
            fail("amira_results.tsv of the seed-7 isolate differs from the golden")
    tables = {"sorted": dict(kmer.SORTED_TABLES), "dense": dict(kmer.DENSE_TABLES)}
    print(
        f"phase 3 golden: amira_results.tsv equals the committed golden ({time.time() - t0:.1f} s); "
        f"k-mer tables {tables}"
    )
    return files, tables


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


def check_scale_rows(out, label):
    """The scale isolate's amira_results.tsv under `out`: two amrX rows and
    one amrY row, each matching allele NG001 at >= 99 % identity. Prints
    and returns the rows."""
    with open(os.path.join(out, "amira_results.tsv")) as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    for r in rows:
        print(
            f"{label} result: {r['Determinant name']} {r['Amira allele']} "
            f"{r['Closest reference']} identity {r['Identity (%)']} "
            f"copy number {r['Approximate cellular copy number']}"
        )
    names = sorted(r["Determinant name"] for r in rows)
    if names != ["amrX", "amrX", "amrY"]:
        fail(f"{label}: expected amrX x2 + amrY, got {names}")
    for r in rows:
        if r["Closest reference"] != "NG001":
            fail(f"{label}: {r['Amira allele']}: closest reference {r['Closest reference']}")
        if float(r["Identity (%)"].split("/")[0]) < 99.0:
            fail(f"{label}: {r['Amira allele']}: identity {r['Identity (%)']}")
    return rows


def scale_files(d, n_reads):
    """Generates phase 4's isolate under `d`/data (scale_run.py's generator
    cut to `n_reads` reads) and writes its files, gene sequences and the
    SHA-256 of its decompressed FASTQ to `d`/files.json. Run by
    start_scale_isolate in a child process with PYTHONHASHSEED=0:
    make_isolate draws gene sequences in the order of a set of names, which
    follows string hashing, so the bases are the same in every call only
    with the hash seed fixed."""
    import gzip
    import hashlib

    from synthetic import make_isolate

    files = make_isolate(
        os.path.join(d, "data"), n_reads=n_reads, seed=17, layout=scale_layout(),
        amr_genes=("amrX", "amrY"), genes_per_read=(10, 20), gene_len=400,
        fast=True, call_noise=0.05,
    )
    digest = hashlib.sha256()
    with gzip.open(files["fastq"], "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            digest.update(chunk)
    files["fastq_sha256"] = digest.hexdigest()
    with open(os.path.join(d, "files.json"), "w") as f:
        json.dump(files, f)


def start_scale_isolate(n_reads):
    """Starts generating phase 4's isolate (scale_files) in a child process
    with PYTHONHASHSEED=0, so that it overlaps phases 1-3; returns
    (process, directory, start time)."""
    d = os.path.join(WORK, "scale")
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ, PYTHONHASHSEED="0")
    env["PYTHONPATH"] = os.pathsep.join([ROOT, os.path.join(ROOT, "tests")])
    code = f"import chip_smoke; chip_smoke.scale_files({d!r}, {n_reads})"
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env)
    # a phase that fails before phase 4 exits: stop the child with it
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, d, time.time()


def wait_scale_isolate(started, n_reads):
    """Waits for start_scale_isolate's child; returns the isolate's files."""
    proc, d, t0 = started
    if proc.wait() != 0:
        fail(f"generating phase 4's isolate failed (exit {proc.returncode})")
    with open(os.path.join(d, "files.json")) as f:
        files = json.load(f)
    print(
        f"phase 4 generated {n_reads} reads in a child process (PYTHONHASHSEED=0) "
        f"{time.time() - t0:.1f} s after it started (host, overlapping phases 1-3, "
        f"not timed below); FASTQ sha256 {files['fastq_sha256']}"
    )
    return files


def run_main_path(files, device):
    """Phase 4: the main path at a real isolate size, on the isolate of
    start_scale_isolate. Returns its summary and the output directory."""
    import torch

    from amira_tpu_torch.ops import graph_tables, kmer, sw_batch

    d = os.path.join(WORK, "scale")
    n_reads = files["n_reads"]
    out = os.path.join(d, "out")
    for counts in (sw_batch.LAUNCHES, graph_tables.DEVICE_RUNS, kmer.DENSE_TABLES, kmer.SORTED_TABLES):
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
    dp_shapes = [[B, Lq, W, n] for (B, Lq, W), n in sw_batch.DP_SHAPES.items()]
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(out, "phase_timings.json")) as f:
        phases = json.load(f)
    for p in phases:
        print(f"phase 4 timing: {p['phase']:<24s} {p['seconds']:9.3f} s")
    print(
        f"phase 4 main path: {wall_s:.1f} s wall, peak device memory "
        f"{peak} bytes ({peak / 2**30:.2f} GiB), launches {launches}, "
        f"window-hash runs {graph_tables.DEVICE_RUNS}, dense tables {kmer.DENSE_TABLES}, "
        f"sorted tables {kmer.SORTED_TABLES}"
    )
    print(f"phase 4 sw_dp launches by shape (B, Lq, W, launches): {dp_shapes}")
    rows = check_scale_rows(out, "phase 4")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    if graph_tables.DEVICE_RUNS["cuda"] <= 0:
        fail("no graph build hashed its windows on the card")
    if kmer.DENSE_TABLES["cuda"] <= 0:
        fail("the dense k-mer table was not allocated on the card")
    return {
        "reads": n_reads,
        "fastq_sha256": files["fastq_sha256"],
        "wall_seconds": wall_s,
        "peak_device_memory_bytes": peak,
        "launches": launches,
        "dp_shapes": dp_shapes,
        "window_hash_runs": dict(graph_tables.DEVICE_RUNS),
        "dense_tables": dict(kmer.DENSE_TABLES),
        "sorted_tables": dict(kmer.SORTED_TABLES),
        "phases": phases,
        "rows": rows,
    }, out


def ptxas_report(path):
    """{kernel instance: (registers, spill store bytes, spill load bytes)}
    from ptxas's -v report of the sw_batch build."""
    import re

    report, name = {}, None
    with open(path) as f:
        for line in f:
            m = re.search(r"(?:Compiling entry function|Function properties for) '?(\w+)'?", line)
            if m:
                name = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                report.setdefault(name, [0, 0, 0])[1:] = int(m.group(1)), int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                report.setdefault(name, [0, 0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in report.items()}


def check_w512_edges(device, ptxas):
    """Phase 5a, first part: the W = 512 instances' registers and spills,
    and both kernels exact against their plain versions at W512_EDGE_SHAPE
    (sw_inputs with its edge cases) and on random traceback bytes at
    W512_RANDOM_SHAPE."""
    instances = {
        "sw_dp_kernel<16>": "sw_dp_kernelILi16E",
        "sw_traceback_kernel<512>": "sw_traceback_kernelILi512E",
    }
    regs = {}
    for label, key in instances.items():
        found = [v for k, v in ptxas.items() if key in k]
        if not found:
            fail(f"ptxas reported no {label}")
        r, st, ld = found[0]
        regs[label] = {"registers": r, "spill_stores": st, "spill_loads": ld}
        print(f"phase 5a ptxas {label}: {r} registers, {st} bytes spill stores, {ld} bytes spill loads")
    W, Lq, B = W512_EDGE_SHAPE
    _, errs, _, _, _ = check_shape(W, Lq, B, device, "phase 5a", edges=True)
    errs["sw_traceback_random"] = check_random_walks(device, [W512_RANDOM_SHAPE], "phase 5a")
    return {"ptxas": regs, "edge_max_abs_err": errs}


def check_w512_at(shape, device):
    """Phase 5a, second part: both kernels exact against their plain
    versions at (B, Lq, W) = `shape` (5c's largest W = 512 launch; query
    lengths 3/4 Lq to Lq), and timed there beside their bounds."""
    B, Lq, W = shape
    inputs, errs, _, _, plain_ms = check_shape(W, Lq, B, device, "phase 5a", min_len=3 * Lq // 4)
    # the plain versions' times are those of their one call in the check: a
    # Python loop of Lq rows (or of the walk's steps), seconds each here
    timed = time_kernels(*inputs, W, label="phase 5a", plain_ms=plain_ms)
    for name, f in timed.items():
        f["max_abs_err"] = errs[name]
    return timed


class KernelClock:
    """CUDA events around every sw_dp and sw_traceback wrapper call while
    active (the counts stay the wrappers' own): the summed milliseconds of
    the wrappers' spans on the stream. A span holds the kernel and the
    wrapper's own allocations and fills, and any time the card waited for
    the host inside the call, so it bounds the kernels' device time from
    above. Reading it synchronises the card."""

    def __init__(self):
        from amira_tpu_torch.ops import sw_batch

        self.sw_batch = sw_batch
        self.events = {"sw_dp": [], "sw_traceback": []}
        self.saved = {}

    def __enter__(self):
        import torch

        for name in self.events:
            fn = getattr(self.sw_batch, name)
            self.saved[name] = fn

            def timed(*args, _fn=fn, _ev=self.events[name]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args)
                end.record()
                _ev.append((start, end))
                return out

            setattr(self.sw_batch, name, timed)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.sw_batch, name, fn)

    def ms(self):
        import torch

        torch.cuda.synchronize()
        return {n: sum(s.elapsed_time(e) for s, e in ev) for n, ev in self.events.items()}


def write_sam_inputs(files, n, d):
    """The phase-4 isolate's first n reads as pandora map would leave them:
    their FASTQ, a pandora-style SAM of their gene calls (one record per
    call, the region as leading hard clips, tests/test_sam_ingestion.py's
    layout) and the consensus: every gene sequence of the isolate (4,000
    genes plus the AMR genes, an E. coli pandora consensus's size).
    Returns (sam, consensus, fastq)."""
    import gzip
    import itertools

    os.makedirs(d, exist_ok=True)
    with open(files["calls"]) as f:
        calls = json.load(f)
    with open(files["positions"]) as f:
        positions = json.load(f)
    fastq = os.path.join(d, "reads.fastq.gz")
    with gzip.open(files["fastq"], "rt") as src, gzip.open(fastq, "wt", 1) as dst:
        lines = list(itertools.islice(src, 4 * n))
        dst.writelines(lines)
    read_ids = [lines[4 * i][1:].strip() for i in range(len(lines) // 4)]
    gene_seqs = files["gene_seqs"]
    sam = os.path.join(d, "pandora.filtered.sam")
    with open(sam, "w") as o:
        o.write("@HD\tVN:1.6\n")
        for g in sorted(gene_seqs):
            o.write(f"@SQ\tSN:{g}\tLN:{len(gene_seqs[g])}\n")
        for r in read_ids:
            for g, (start, end) in zip(calls[r], positions[r]):
                flag = 0 if g[0] == "+" else 16
                clip = f"{start + 1}H" if start > 0 else ""
                o.write(f"{r}\t{flag}\t{g[1:]}\t1\t60\t{clip}{end - start + 1}M\t*\t0\t0\t*\t*\n")
    consensus = os.path.join(d, "pandora.consensus.fq.gz")
    with gzip.open(consensus, "wt", 1) as o:
        for g, seq in gene_seqs.items():
            o.write(f"@{g}\n{seq}\n+\n{'I' * len(seq)}\n")
    return sam, consensus, fastq, len(read_ids)


def seed_chains_per_gene(qkmers, ref_index, band_width, max_occ=8, max_chains=4):
    """The seeding before the one-index `_SeedIndex`: one query strand's
    seed chains against ONE gene's own seed index, as the JAX package's
    `_seed_chains` (amira_tpu/ops/align.py) computes them. Query k-mers
    seen more than max_occ times in the gene are dropped; the sorted
    diagonals split into chains where they jump by more than half the
    band. Returns up to max_chains (median diagonal, seeds), most seeds
    first."""
    import numpy as np

    qk, qpos = qkmers
    rk_codes, rk_pos = ref_index
    if len(qk) == 0 or len(rk_codes) == 0:
        return []
    lo = np.searchsorted(rk_codes, qk, side="left")
    hi = np.searchsorted(rk_codes, qk, side="right")
    counts = hi - lo
    keep = (counts > 0) & (counts <= max_occ)
    if not keep.any():
        return []
    reps = counts[keep]
    total = int(reps.sum())
    starts = np.repeat(lo[keep], reps)
    offsets = np.concatenate([[0], np.cumsum(reps)[:-1]])
    within = np.arange(total, dtype=np.int64) - np.repeat(offsets, reps)
    d_sorted = np.sort(rk_pos[starts + within] - np.repeat(qpos[keep], reps), kind="stable")
    breaks = np.nonzero(np.diff(d_sorted) > band_width // 2)[0] + 1
    bounds = np.concatenate([[0], breaks, [total]])
    chains = [(int(np.median(d_sorted[b0:b1])), int(b1 - b0)) for b0, b1 in zip(bounds[:-1], bounds[1:])]
    chains.sort(key=lambda c: -c[1])
    return chains[:max_chains]


def time_seeding(consensus, fastq, n, device):
    """The consensus QC's seeding on the first n reads, before and after
    the one-index seeding: a loop over the consensus genes, each with its
    own seed index (built first and not timed), as the JAX package seeds,
    against `Aligner._jobs_for`; the job lists must be equal. Returns (ms
    per read of the loop, ms per read of `_jobs_for`, jobs)."""
    import gzip
    import itertools

    from amira_tpu_torch.io import parse_fastq
    from amira_tpu_torch.ops.align import (
        Aligner, build_ref_seed_index, query_seed_kmers, reverse_complement,
    )
    from amira_tpu_torch.sketch import encode_dna

    refs = {g: v["sequence"] for g, v in parse_fastq(consensus).items()}
    aligner = Aligner(refs, device=device)
    indexes = {g: build_ref_seed_index(aligner.ref_codes[g], aligner.seed_k) for g in refs}
    with gzip.open(fastq, "rt") as f:
        lines = list(itertools.islice(f, 4 * n))
    reads = {lines[i][1:].strip(): lines[i + 1].strip() for i in range(0, len(lines), 4)}
    aligner._jobs_for("warm-up", next(iter(reads.values())), 2)  # builds the index
    loop_s = index_s = 0.0
    n_jobs = 0
    for rid, seq in reads.items():
        t = time.time()
        jobs = []
        for strand, qseq in (("+", seq), ("-", reverse_complement(seq))):
            qkmers = query_seed_kmers(encode_dna(qseq), aligner.seed_k)
            for name in aligner.ref_names:
                chains = seed_chains_per_gene(qkmers, indexes[name], aligner.band_width)
                top = chains[0][1] if chains else 0
                jobs.extend(
                    ((rid, name), strand, qseq, diag) for diag, cnt in chains
                    if not (cnt < 2 or cnt * 20 < top)
                )
        loop_s += time.time() - t
        t = time.time()
        got = aligner._jobs_for(rid, seq, 2)
        index_s += time.time() - t
        if got != jobs:
            fail(f"phase 5b: the one-index seeding's jobs differ from the per-gene loop's for {rid}")
        n_jobs += len(jobs)
    return 1e3 * loop_s / len(reads), 1e3 * index_s / len(reads), n_jobs


def run_sam_route(files, n_reads, device):
    """Phase 5b: the SAM route (pandora SAM + consensus) on the first
    n_reads reads of the phase-4 isolate with --device cuda. Its consensus
    QC aligns every read against every consensus gene: this phase times the
    QC's seeding (`Aligner._jobs_for`) and alignment (`Aligner._run_jobs`)
    apart, counts its jobs and kernel launches, and sums the kernel
    wrappers' spans on the stream over the run (`KernelClock`). The result must hold phase 4's rows and the QC must
    have launched both kernels."""
    import torch

    from amira_tpu_torch import preprocess
    from amira_tpu_torch.ops import sw_batch
    from amira_tpu_torch.ops.align import Aligner

    d = os.path.join(WORK, "sam")
    t0 = time.time()
    sam, consensus, fastq, n = write_sam_inputs(files, n_reads, os.path.join(d, "data"))
    print(f"phase 5b inputs: {n} reads, SAM and a consensus of {len(files['gene_seqs'])} genes written in {time.time() - t0:.1f} s (host, not timed below)")
    qc = {"jobs": 0, "seeding_s": 0.0, "alignment_s": 0.0}
    real_qc = preprocess.remove_poorly_mapped_genes
    real_jobs_for, real_run_jobs = Aligner._jobs_for, Aligner._run_jobs

    def jobs_for(self, *args, **kwargs):
        t = time.time()
        jobs = real_jobs_for(self, *args, **kwargs)
        qc["seeding_s"] += time.time() - t
        qc["jobs"] += len(jobs)
        return jobs

    def run_jobs(self, jobs):
        t = time.time()
        out = real_run_jobs(self, jobs)
        torch.cuda.synchronize()
        qc["alignment_s"] += time.time() - t
        return out

    def timed_qc(*args, **kwargs):
        before = dict(sw_batch.LAUNCHES)
        Aligner._jobs_for, Aligner._run_jobs = jobs_for, run_jobs
        t = time.time()
        try:
            return real_qc(*args, **kwargs)
        finally:
            Aligner._jobs_for, Aligner._run_jobs = real_jobs_for, real_run_jobs
            qc["seconds"] = time.time() - t
            qc["launches"] = {k: sw_batch.LAUNCHES[k] - before[k] for k in before}

    argv = [
        "--pandoraSam", sam, "--pandoraConsensus", consensus, "--reads", fastq,
        "--species", "Escherichia_coli", "--amr-fasta", files["amr_fasta"],
        "--amr-calls", files["amr_calls"], "--core-genes", files["core_genes"],
        "--plasmid-genes", files["plasmid_genes"], "--output", os.path.join(d, "out"),
        "--quiet", "--device", device,
    ]
    for key in sw_batch.LAUNCHES:
        sw_batch.LAUNCHES[key] = 0
    sw_batch.DP_SHAPES.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    preprocess.remove_poorly_mapped_genes = timed_qc
    t0 = time.time()
    try:
        with KernelClock() as clock:
            run_cli(argv)
            torch.cuda.synchronize()
            wall_s = time.time() - t0
    finally:
        preprocess.remove_poorly_mapped_genes = real_qc
    span_ms = clock.ms()
    launches = dict(sw_batch.LAUNCHES)
    dp_shapes = sorted(
        ([B, Lq, W, k] for (B, Lq, W), k in sw_batch.DP_SHAPES.items()),
        key=lambda x: (x[2], x[1], x[0]),
    )
    peak = torch.cuda.max_memory_allocated()
    out = os.path.join(d, "out")
    with open(os.path.join(out, "phase_timings.json")) as f:
        phases = json.load(f)
    for p in phases:
        print(f"phase 5b timing: {p['phase']:<24s} {p['seconds']:9.3f} s")
    print(
        f"phase 5b SAM route: {n} reads, {wall_s:.1f} s wall ({1e3 * wall_s / n:.2f} ms per read), "
        f"peak device memory {peak} bytes ({peak / 2**30:.2f} GiB), launches {launches}"
    )
    print(
        f"phase 5b consensus QC: {qc['seconds']:.1f} s, {qc['jobs']} jobs, seeding "
        f"{qc['seeding_s']:.1f} s ({1e3 * qc['seeding_s'] / n:.2f} ms per read), alignment "
        f"{qc['alignment_s']:.1f} s, kernel launches {qc['launches']}"
    )
    print(
        f"phase 5b kernel wrappers' spans on the stream over the run: sw_dp {span_ms['sw_dp']:.1f} ms, sw_traceback "
        f"{span_ms['sw_traceback']:.1f} ms, {100 * sum(span_ms.values()) / (1e3 * wall_s):.2f} % of the wall"
    )
    print(f"phase 5b sw_dp launches by shape (B, Lq, W, launches): {dp_shapes}")
    rows = check_scale_rows(out, "phase 5b")
    loop_ms, index_ms, seed_jobs = time_seeding(consensus, fastq, SEEDING_READS, device)
    print(
        f"phase 5b seeding of the first {SEEDING_READS} read(s) ({seed_jobs} jobs, equal): "
        f"a seed index per gene, looped {loop_ms:.2f} ms per read; one index over all "
        f"genes {index_ms:.2f} ms per read"
    )
    qc["seeding_loop_ms_per_read"], qc["seeding_index_ms_per_read"] = loop_ms, index_ms
    if not all(qc["launches"][k] > 0 for k in ("sw_dp", "sw_traceback")) or qc["jobs"] <= 0:
        fail(f"phase 5b: the consensus QC did not align on the card ({qc})")
    for name in ("gene_calls_with_gene_filtering.json", "gene_positions_with_gene_filtering.json"):
        if not os.path.exists(os.path.join(out, name)):
            fail(f"phase 5b: {name} was not written")
    return {
        "reads": n, "wall_seconds": wall_s, "ms_per_read": 1e3 * wall_s / n,
        "peak_device_memory_bytes": peak, "launches": launches, "dp_shapes": dp_shapes,
        "span_ms": span_ms, "qc": qc, "phases": phases, "rows": rows,
    }


def run_assemble_paths(out, device):
    """Phase 5c: `assemble_full_length_paths` (--assemble-paths) on phase
    4's AMR_allele_fastqs/path_reads/ with device="cuda", timed. Every path
    must give at least one contig; the polish runs at W = 512. Returns its
    summary, with the largest W = 512 sw_dp launch (B, Lq, W)."""
    import glob

    import torch

    from amira_tpu_torch.assembly import assemble_full_length_paths
    from amira_tpu_torch.ops import sw_batch

    paths = sorted(glob.glob(os.path.join(out, "AMR_allele_fastqs", "path_reads", "*.fastq.gz")))
    shutil.rmtree(os.path.join(out, "path_assemblies"), ignore_errors=True)
    for key in sw_batch.LAUNCHES:
        sw_batch.LAUNCHES[key] = 0
    sw_batch.DP_SHAPES.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    assemble_full_length_paths(out, device=device)
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(sw_batch.LAUNCHES)
    w512 = {k: n for k, n in sw_batch.DP_SHAPES.items() if k[2] == 512}
    contigs = {}
    for p in paths:
        path_id = os.path.basename(p).replace(".fastq.gz", "")
        fasta = os.path.join(out, "path_assemblies", f"path_{path_id}", "assembly.fasta")
        heads = []
        if os.path.exists(fasta):
            with open(fasta) as f:
                heads = [line[1:].strip() for line in f if line.startswith(">")]
        contigs[path_id] = heads
        print(f"phase 5c path {path_id}: {len(heads)} contigs: {'; '.join(heads)}")
    print(
        f"phase 5c assemble_full_length_paths: {len(paths)} paths in {seconds:.1f} s, "
        f"launches {launches}, W=512 sw_dp launches by (B, Lq): "
        f"{sorted([B, Lq, n] for (B, Lq, _), n in w512.items())}"
    )
    if not paths:
        fail("phase 5c: phase 4 wrote no path reads")
    missing = [p for p, heads in contigs.items() if not heads]
    if missing:
        fail(f"phase 5c: no contig for paths {missing}")
    if not w512:
        fail("phase 5c: no W = 512 sw_dp launch")
    largest = max(w512, key=lambda k: (k[0] * k[1], k[1]))
    return {
        "paths": len(paths), "seconds": seconds, "launches": launches,
        "w512_dp_shapes": [[B, Lq, n] for (B, Lq, _), n in w512.items()],
        "largest_w512": list(largest), "contigs": contigs,
    }


def check_modes(device):
    """Phase 5d: --assembly, --meta and --promoter-mutations with --device
    cuda on their small isolates write the committed goldens byte for
    byte; on the seed-7 isolate, --assemble-paths on the card writes the
    golden TSV and the same path_assemblies FASTAs as
    `assemble_full_length_paths` on the CPU from the same path reads."""
    import glob

    from amira_tpu_torch.assembly import assemble_full_length_paths
    from synthetic import make_isolate

    out = {}
    for mode, golden in MODE_GOLDENS.items():
        d = os.path.join(WORK, "modes", mode)
        t0 = time.time()
        run_cli(mode_argv(mode, d) + ["--output", os.path.join(d, "out"), "--device", device])
        with open(os.path.join(d, "out", "amira_results.tsv")) as f, open(
            os.path.join(ROOT, "tests", "goldens", golden)
        ) as g:
            if f.read() != g.read():
                fail(f"phase 5d: --{mode} amira_results.tsv differs from tests/goldens/{golden}")
        out[mode] = time.time() - t0
        print(f"phase 5d {mode}: amira_results.tsv equals tests/goldens/{golden} ({out[mode]:.1f} s)")
    d = os.path.join(WORK, "modes", "assemble_paths")
    files = make_isolate(
        os.path.join(d, "data"), seed=7, n_reads=90, amr_genes=("amrX", "amrY"),
        layout=["geneA", "geneB", "amrX", "geneC", "geneD", "amrY", "geneE", "geneF"],
    )
    card = os.path.join(d, "out")
    t0 = time.time()
    run_cli(cli_args(files, card, device) + ["--assemble-paths"])
    with open(os.path.join(card, "amira_results.tsv")) as f, open(GOLDEN) as g:
        if f.read() != g.read():
            fail("phase 5d: --assemble-paths changed the seed-7 amira_results.tsv")
    card_s = time.time() - t0
    cpu = os.path.join(d, "cpu")
    shutil.copytree(
        os.path.join(card, "AMR_allele_fastqs", "path_reads"),
        os.path.join(cpu, "AMR_allele_fastqs", "path_reads"),
    )
    t0 = time.time()
    assemble_full_length_paths(cpu, device="cpu")
    cpu_s = time.time() - t0
    fastas = sorted(
        os.path.relpath(p, card)
        for p in glob.glob(os.path.join(card, "path_assemblies", "*", "assembly.fasta"))
    )
    if not fastas:
        fail("phase 5d: --assemble-paths wrote no path assembly")
    for rel in fastas:
        with open(os.path.join(card, rel)) as f, open(os.path.join(cpu, rel)) as g:
            if f.read() != g.read():
                fail(f"phase 5d: {rel} differs between the card and the CPU")
    print(
        f"phase 5d --assemble-paths: {len(fastas)} path FASTAs equal on the card "
        f"({card_s:.1f} s, the whole CLI) and the CPU ({cpu_s:.1f} s, the assembly alone)"
    )
    out["assemble_paths"] = {"fastas": fastas, "card_seconds": card_s, "cpu_seconds": cpu_s}
    return out


class RssPeak:
    """The process's resident set size (VmRSS of /proc/self/status) sampled
    every 50 ms on a thread while active: its value on entry and its peak
    (bytes)."""

    def __init__(self):
        import threading

        self.start = self.peak = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    @staticmethod
    def _rss():
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
        return 0

    def _sample(self):
        while not self._stop.wait(0.05):
            self.peak = max(self.peak, self._rss())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)
        self.peak = max(self.peak, self._rss())


def run_batch_phase(files, scale_out, device):
    """Phase 6a: `batch.run_batch` on a manifest of BATCH_ISOLATES copies of
    phase 4's isolate (its input files, an output directory each) with
    --device cuda, once per worker count in BATCH_WORKERS (workers > 1: one
    stream per worker thread on the one card). Every isolate's
    amira_results.tsv must equal phase 4's byte for byte and every isolate
    must have launched both kernels (counted in its own thread:
    `sw_batch.thread_launches`; `sw_batch.LAUNCHES` sums over the batch).
    Prints each run's wall, isolates per hour, peak device memory and the
    host's peak resident set."""
    import torch

    from amira_tpu_torch import batch
    from amira_tpu_torch.ops import sw_batch

    with open(os.path.join(scale_out, "amira_results.tsv")) as f:
        want = f.read()
    entry = {
        "pandoraJSON": files["calls"], "gene-positions": files["positions"],
        "reads": files["fastq"], "species": "Escherichia_coli",
        "amr-fasta": files["amr_fasta"], "amr-calls": files["amr_calls"],
        "core-genes": files["core_genes"], "plasmid-genes": files["plasmid_genes"],
        "quiet": True,
    }
    real_run_isolate = batch.run_isolate
    own_launches = {}

    def counted(argv, dev=None):
        sw_batch.thread_launches(reset=True)
        summary = real_run_isolate(argv, dev)
        own_launches[summary["output"]] = sw_batch.thread_launches(reset=True)
        return summary

    runs = {}
    for workers in BATCH_WORKERS:
        root = os.path.join(WORK, "batch", f"w{workers}")
        manifest = [
            {"name": f"iso{i}", **entry, "output": os.path.join(root, f"iso{i}")}
            for i in range(BATCH_ISOLATES)
        ]
        for key in sw_batch.LAUNCHES:
            sw_batch.LAUNCHES[key] = 0
        sw_batch.DP_SHAPES.clear()
        own_launches.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        batch.run_isolate = counted
        try:
            with RssPeak() as rss:
                t0 = time.time()
                summaries = batch.run_batch(manifest, workers=workers, quiet=True, device=device)
                torch.cuda.synchronize()
                wall_s = time.time() - t0
        finally:
            batch.run_isolate = real_run_isolate
        launches = dict(sw_batch.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        per_hour = 3600.0 * len(manifest) / wall_s
        print(
            f"phase 6a batch of {len(manifest)} isolates, {workers} worker(s) "
            f"({workers} stream(s) on {device}): {wall_s:.1f} s wall, {per_hour:.1f} isolates "
            f"per hour, peak device memory {peak} bytes ({peak / 2**30:.2f} GiB), host resident "
            f"set {rss.start} bytes at the start, peak {rss.peak} bytes ({rss.peak / 2**30:.2f} "
            f"GiB), launches {launches} (summed over the batch)"
        )
        phase_means = {}
        for s in summaries:
            with open(os.path.join(s["output"], "phase_timings.json")) as f:
                for p in json.load(f):
                    phase_means[p["phase"]] = phase_means.get(p["phase"], 0.0) + p["seconds"] / len(summaries)
        print(
            f"phase 6a phases (workers={workers}, mean s over isolates): "
            + ", ".join(f"{k} {v:.3f}" for k, v in phase_means.items())
        )
        for s in summaries:
            mine = own_launches.get(s["output"], {})
            print(
                f"phase 6a isolate {os.path.basename(s['output'])} (workers={workers}): "
                f"{s['status']}, {s['seconds']} s, launches {mine}"
            )
            if s["status"] != "ok":
                fail(f"phase 6a: isolate {s['output']} failed: {s['status']}")
            with open(s["results_tsv"]) as f:
                if f.read() != want:
                    fail(f"phase 6a: {s['results_tsv']} differs from phase 4's amira_results.tsv")
            if not all(mine.get(k, 0) > 0 for k in ("sw_dp", "sw_traceback")):
                fail(f"phase 6a: isolate {s['output']} did not launch both kernels ({mine})")
        runs[f"w{workers}"] = {
            "isolates": len(manifest), "workers": workers, "wall_seconds": wall_s,
            "isolates_per_hour": per_hour, "peak_device_memory_bytes": peak,
            "host_rss_start_bytes": rss.start, "host_rss_peak_bytes": rss.peak,
            "launches": launches,
            "isolates_seconds": [s["seconds"] for s in summaries],
            "phase_means": phase_means,
            "isolate_launches": [own_launches[s["output"]] for s in summaries],
        }
    return runs


def card_timed(fn):
    """fn() and its seconds, the card synchronized before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def graph_state(graph):
    """What phase 6b holds equal between two graphs: node hashes in order
    with coverages, read lists and edge lists; edges in order with their
    endpoints, directions and coverage; readNodes."""
    nodes = [
        (h, n.coverage, n.reads, n.fwd_edges, n.bwd_edges)
        for h, n in graph.get_nodes().items()
    ]
    edges = [
        (key, e.src, e.tgt, e.src_dir, e.tgt_dir, e.coverage)
        for key, e in graph.get_edges().items()
    ]
    return nodes, edges, graph.get_readNodes()


def run_dist_build(files, device):
    """Phase 6b: the distributed graph build (--dist-build's) on the card.
    The initial gene calls of phase 4's isolate, as the pipeline ingests
    them, are built at k = 3 by `distributed_graph_build` over DIST_SHARDS
    shards of the one card ([cuda:0] * DIST_SHARDS) and over ["cpu"]; the
    two graphs must be equal (graph_state). Prints the seconds of both
    (the card's twice: its first call and a second), and of the cached
    single-device `build_graph` on the card, as the pipeline's default
    build."""
    import torch

    from amira_tpu_torch.graph_cache import GraphBuildCache
    from amira_tpu_torch.graph_utils import build_graph
    from amira_tpu_torch.parallel.distgraph import distributed_graph_build
    from amira_tpu_torch.preprocess import (
        load_species_specific_files, process_pandora_json, process_reference_alleles,
    )
    from amira_tpu_torch.vocab import GeneVocab

    fasta, _, _, _ = load_species_specific_files(
        "Escherichia_coli", files["amr_fasta"], files["amr_calls"], files["core_genes"],
        files["plasmid_genes"],
    )
    _, genes_of_interest = process_reference_alleles(fasta, False)
    reads, _, positions = process_pandora_json(files["calls"], genes_of_interest, files["positions"])
    reads = dict(sorted(reads.items()))
    n_genes = sum(len(g) for g in reads.values())
    card = torch.device(device, 0) if torch.device(device).index is None else torch.device(device)
    dist = lambda devs: distributed_graph_build(  # noqa: E731
        reads, 3, devs, vocab=GeneVocab(), gene_positions=positions
    )
    on_card, card_s = card_timed(lambda: dist([card] * DIST_SHARDS))
    _, card_again_s = card_timed(lambda: dist([card] * DIST_SHARDS))
    on_cpu, cpu_s = card_timed(lambda: dist(["cpu"]))
    _, cached_s = card_timed(lambda: build_graph(reads, 3, positions, GeneVocab(), GraphBuildCache(card)))
    t0 = time.time()
    state = graph_state(on_card)
    equal = state == graph_state(on_cpu)
    compare_s = time.time() - t0
    print(
        f"phase 6b distributed build (k=3, {len(reads)} reads, {n_genes} genes, "
        f"{len(state[0])} nodes, {len(state[1])} edges): {DIST_SHARDS} shards on {card} "
        f"{card_s:.3f} s (again {card_again_s:.3f} s), 1 shard on the CPU {cpu_s:.3f} s, "
        f"cached single-device build_graph on {card} {cached_s:.3f} s; graphs equal: {equal} "
        f"(compared in {compare_s:.1f} s)"
    )
    if not equal:
        fail("phase 6b: the distributed build on the card differs from the one on the CPU")
    return {
        "reads": len(reads), "genes": n_genes, "nodes": len(state[0]), "edges": len(state[1]),
        "shards": DIST_SHARDS, "card_seconds": card_s, "card_again_seconds": card_again_s,
        "cpu_seconds": cpu_s, "cached_build_seconds": cached_s,
    }, (reads, positions, state)


def run_table_meshes(initial, device):
    """Phase 6c: `distributed_graph_build` of phase 6b's reads at k = 3 on
    a ("data", "table") mesh of 2 x 2 shards of the card and on a ("host",
    "data", "table") mesh of 2 x 2 x 2; each graph must equal phase 6b's
    (graph_state). Prints both calls' seconds on each mesh."""
    import numpy as np

    from amira_tpu_torch import resolve_device
    from amira_tpu_torch.parallel.distgraph import distributed_graph_build
    from amira_tpu_torch.parallel.mesh import Mesh
    from amira_tpu_torch.vocab import GeneVocab

    reads, positions, want = initial
    card = resolve_device(device + ":0")
    out = {}
    for shape, axes in (((2, 2), ("data", "table")), ((2, 2, 2), ("host", "data", "table"))):
        mesh = Mesh(np.array([card] * int(np.prod(shape)), dtype=object).reshape(shape), axes)
        build = lambda: distributed_graph_build(  # noqa: E731
            reads, 3, mesh, vocab=GeneVocab(), gene_positions=positions
        )
        graph, first_s = card_timed(build)
        _, again_s = card_timed(build)
        equal = graph_state(graph) == want
        label = " x ".join(map(str, shape)) + " (" + ", ".join(axes) + ")"
        print(
            f"phase 6c distributed build on {label} shards of {card}: {first_s:.3f} s "
            f"(again {again_s:.3f} s); graph equals phase 6b's: {equal}"
        )
        if not equal:
            fail(f"phase 6c: the build on the {label} mesh differs from phase 6b's")
        out[label] = {"seconds": first_s, "again_seconds": again_s}
    return out


def read_sequences(files, n=None):
    """The phase-4 isolate's read sequences, in FASTQ order (the first n)."""
    from amira_tpu_torch.io import parse_fastq

    seqs = [r["sequence"] for r in parse_fastq(files["fastq"]).values()]
    return seqs if n is None else seqs[:n]


def run_dist_kmer(seqs, device):
    """Phase 6d: the bin-sharded k-mer table at k = KMER_K over phase 4's
    reads, over DIST_SHARDS shards of the card (`make_distributed_kmer_step`
    on the stream split as `distributed_kmer_count` splits it), held with
    torch.equal on the card to the dense table `KmerCounter` builds there
    from the same reads, bin range by bin range (bin 4^k, the invalid
    windows, left out; the padding bins past it must be zero). Prints the
    host split and pack, the step's and the counter's seconds and the peak
    device memory of each."""
    import torch

    from amira_tpu_torch import resolve_device
    from amira_tpu_torch.ops.kmer import KmerCounter, _concat_codes
    from amira_tpu_torch.parallel.distgraph import kmer_layout, kmer_rows, make_distributed_kmer_step

    card = resolve_device(device + ":0")
    k, D = KMER_K, DIST_SHARDS
    t0 = time.time()
    codes = _concat_codes(seqs)
    words, bad, chunk = kmer_rows(codes, k, D)
    host_s = time.time() - t0
    torch.cuda.reset_peak_memory_stats(card)
    step = make_distributed_kmer_step([card] * D, k, chunk)
    shards, step_s = card_timed(lambda: step(words, bad))
    step_peak = torch.cuda.max_memory_allocated(card)
    torch.cuda.reset_peak_memory_stats(card)
    counter, counter_s = card_timed(lambda: KmerCounter.from_sequences(seqs, k, device=card))
    counter_peak = torch.cuda.max_memory_allocated(card)
    Tp, B = kmer_layout(k, D)
    n_bins, equal = 4**k, True
    for d, shard in enumerate(shards):
        lo, hi = d * B, min((d + 1) * B, n_bins)
        equal &= shard.shape[0] == B and torch.equal(shard[: hi - lo], counter.dense[lo:hi])
        if (d + 1) * B > n_bins + 1:
            equal &= not bool(shard[n_bins + 1 - lo :].any())
    windows = int(sum(int(s.sum(dtype=torch.int64)) for s in shards))
    print(
        f"phase 6d distributed k-mer table (k={k}, {len(seqs)} reads, {len(codes)} codes, "
        f"{D} shards of {card}, {B} bins a shard): host split and pack {host_s:.3f} s, step "
        f"{step_s:.3f} s (peak {step_peak} bytes), KmerCounter on the card {counter_s:.3f} s "
        f"(peak {counter_peak} bytes); {windows} windows; equal to the counter: {equal}"
    )
    if not equal:
        fail("phase 6d: the bin-sharded k-mer table differs from KmerCounter's")
    del shards, counter
    torch.cuda.empty_cache()
    return {"k": k, "shards": D, "codes": len(codes), "host_seconds": host_s,
            "step_seconds": step_s, "step_peak_bytes": step_peak,
            "counter_seconds": counter_s, "counter_peak_bytes": counter_peak}


def run_two_processes(initial, seqs, device):
    """Phase 6e: two processes (`parallel.multiproc`, new interpreters) on
    the one card with backend gloo, four shards each: the ("host", "data",
    "table") = (2, 2, 2) count step on phase 4's initial calls with "host"
    on the process boundary, and the k-mer step at k = KMER_K on `seqs`
    with its bins over all eight shards (each process checks its range
    against KmerCounter on the card). Both are held to the same steps in
    this process: the count tables equal, each bin range's digest equal.
    Prints the wall, each process's step seconds and the bytes that
    crossed the process boundary. A worker that hangs past the timeout is
    killed and its stderr printed."""
    import numpy as np
    import torch

    from amira_tpu_torch import resolve_device
    from amira_tpu_torch.ops.kmer import _concat_codes
    from amira_tpu_torch.parallel import multiproc
    from amira_tpu_torch.parallel.distgraph import (
        distributed_node_counts_3d, kmer_layout, kmer_rows, make_distributed_kmer_step,
    )
    from amira_tpu_torch.parallel.mesh import Mesh
    from amira_tpu_torch.vocab import GeneVocab, pack_reads

    card = resolve_device(device + ":0")
    torch.cuda.empty_cache()  # the workers share the card with this process
    d = os.path.join(WORK, "multiproc")
    os.makedirs(d, exist_ok=True)
    reads = initial[0]
    tokens, lengths = pack_reads(GeneVocab().encode_reads_batch(list(reads.values())))
    tokens_file, seqs_file = os.path.join(d, "tokens.npz"), os.path.join(d, "seqs.txt")
    np.savez(tokens_file, tokens=tokens, lengths=lengths)
    with open(seqs_file, "w") as f:
        f.write("\n".join(seqs) + "\n")
    t0 = time.time()
    results = multiproc.run_workers(
        os.path.join(d, "out"), "gloo", [str(card)] * 2, tokens_file, seqs_file, timeout=600
    )
    wall = time.time() - t0
    mesh = Mesh(np.array([card] * 8, dtype=object).reshape(2, 2, 2), ("host", "data", "table"))
    keys, counts, total = distributed_node_counts_3d(tokens, lengths, 3, mesh)
    words, bad, chunk = kmer_rows(_concat_codes(seqs), KMER_K, 8)
    one = make_distributed_kmer_step([card] * 8, KMER_K, chunk)(words, bad)
    B = kmer_layout(KMER_K, 8)[1]
    # the default capacity holds every gene-mer: the tables are phase 6b's nodes
    equal = len(keys) == len(initial[2][0]) and total == int(np.maximum(lengths - 2, 0).sum())
    for r in results:
        with np.load(r["counts_file"]) as z:
            equal &= np.array_equal(z["keys"], keys) and np.array_equal(z["counts"], counts)
        equal &= r["total"] == total and r["kmer_matches_counter"]
        for (lo, _hi), digest in zip(r["kmer_bins"], r["kmer_digests"]):
            equal &= digest == multiproc.bins_digest(one[lo // B], lo)
    del one
    torch.cuda.empty_cache()
    crossed = sum(r["count_bytes_sent"] + r["kmer_bytes_sent"] for r in results)
    print(
        f"phase 6e two processes (gloo, 4 shards of {card} each; count step on {len(reads)} "
        f"reads, {len(keys)} keys, total {total}; k-mer step k={KMER_K} on {len(seqs)} reads): "
        f"wall {wall:.1f} s; count step s by rank {[round(r['count_seconds'], 3) for r in results]}, "
        f"k-mer step s {[round(r['kmer_seconds'], 3) for r in results]}; bytes across the "
        f"process boundary {crossed}; equal to one process: {equal}"
    )
    if not equal:
        fail("phase 6e: the two-process steps differ from the same steps in one process")
    return {"wall_seconds": wall, "bytes_crossed": crossed, "keys": len(keys), "total": total,
            "results": results}


def run_graft_entry(initial, device):
    """Phase 6f: `graft_entry.entry()` on the card, `dryrun_multichip` at
    2, 4 and 8 shards (one card: shards of cuda:0), and `scaling_report`
    over the visible devices on phase 4's initial calls; prints its rows."""
    from amira_tpu_torch import graft_entry
    from amira_tpu_torch.parallel.distgraph import scaling_report
    from amira_tpu_torch.vocab import GeneVocab, pack_reads

    fn, args = graft_entry.entry()
    out, entry_s = card_timed(lambda: fn(*args))
    print(f"phase 6f entry(): local_genemer_tables on {args[0].device} in {entry_s:.3f} s, "
          f"{int((out[0] != 0).sum())} nodes, {int((out[2] != 0).sum())} edge keys")
    dry = {n: graft_entry.dryrun_multichip(n) for n in (2, 4, 8)}
    tokens, lengths = pack_reads(GeneVocab().encode_reads_batch(list(initial[0].values())))
    rows = scaling_report(tokens, lengths, k=3)
    for row in rows:
        print(f"phase 6f scaling_report: {json.dumps(row)}")
    return {"entry_seconds": entry_s, "dryrun": dry, "scaling": rows}


SORTED_CODES = (1 << 16, 1 << 20, (1 << 24) - 1)  # phase 7a's read-set sizes, at most


def median_run(fn, card, reps=3):
    """fn() once to warm up, then `reps` timed runs, each after the last
    one's result is freed: (the last result, the median seconds, the peak
    device memory over the timed runs)."""
    import statistics

    import torch

    fn()
    torch.cuda.reset_peak_memory_stats(card)
    times, out = [], None
    for _ in range(reps):
        out = None
        out, s = card_timed(fn)
        times.append(s)
    return out, statistics.median(times), torch.cuda.max_memory_allocated(card)


def run_sorted_kmer(seqs, path_reads_dir, golden_tables, main_tables, device):
    """Phase 7a: the sorted k-mer counter on the card. The first reads of
    phase 4's isolate, at most SORTED_CODES codes each (the largest just
    under the 2^24 edge), are counted at k = KMER_K by
    `KmerCounter.from_sequences` on the card, which must take the sorted
    counter (SORTED_TABLES grows, DENSE_TABLES does not), and held to the
    dense table of the same reads on the card: the same k-mers and counts,
    histogram and cutoff, the same depth from `estimate_overall_read_depth`,
    and the same `estimate_depth_for_reads` on each AMR path's reads of
    phase 4. Prints n_codes and, for each counter, the median of 3 timed
    runs after a warm-up and their peak device memory. Phase 3's golden
    run must have taken the sorted counter, phase 4 the dense one."""
    import glob

    import numpy as np
    import torch

    from amira_tpu_torch import resolve_device
    from amira_tpu_torch.io import parse_fastq
    from amira_tpu_torch.ops import kmer

    card = resolve_device(device + ":0")
    k = KMER_K
    if not (golden_tables["sorted"]["cuda"] > 0 and golden_tables["dense"]["cuda"] == 0):
        fail(f"phase 7a: phase 3's golden run did not count on the card's sorted counter ({golden_tables})")
    if not (main_tables["dense"]["cuda"] > 0 and main_tables["sorted"]["cuda"] == 0):
        fail(f"phase 7a: phase 4 did not count on the card's dense table ({main_tables})")
    path_seqs = [
        [r["sequence"] for r in parse_fastq(p).values()]
        for p in sorted(glob.glob(os.path.join(path_reads_dir, "*.fastq.gz")))
    ]
    if not path_seqs:
        fail("phase 7a: phase 4 wrote no path reads")
    codes = np.cumsum([len(s) + 1 for s in seqs])
    dense_of = lambda sub: kmer.KmerCounter._from_seqs_dense(sub, k, 0, card)  # noqa: E731
    rows = []
    for limit in SORTED_CODES:
        n_reads = int(np.searchsorted(codes, limit, side="right"))
        sub, n_codes = seqs[:n_reads], int(codes[n_reads - 1])
        for counts in (kmer.SORTED_TABLES, kmer.DENSE_TABLES):
            for key in counts:
                counts[key] = 0
        got = kmer.KmerCounter.from_sequences(sub, k, device=card)
        took = {"sorted": dict(kmer.SORTED_TABLES), "dense": dict(kmer.DENSE_TABLES)}
        if took["sorted"][card.type] != 1 or sum(took["dense"].values()) != 0 or got.dense is not None:
            fail(f"phase 7a: {n_codes} codes did not take the sorted counter on the card ({took})")
        got, sorted_s, sorted_peak = median_run(
            lambda: kmer.KmerCounter.from_sequences(sub, k, device=card), card  # noqa: B023
        )
        ref, dense_s, dense_peak = median_run(lambda: dense_of(sub), card)  # noqa: B023
        nz = torch.nonzero(ref.dense[:-1]).flatten()
        equal = np.array_equal(got.kmers, nz.cpu().numpy().astype(np.uint32)) and np.array_equal(
            got.counts, ref.dense[nz].cpu().numpy().astype(np.int64)
        )
        histo = got.histo()
        equal &= histo == ref.histo()
        cutoff = kmer.kmer_cutoff_estimation(histo)
        equal &= cutoff == kmer.kmer_cutoff_estimation(ref.histo())
        del ref
        depth, filtered = kmer.estimate_overall_read_depth(sub, k, device=card)
        real = kmer.counter_for
        kmer.counter_for = lambda device_type, n: "dense"  # the dense route, same reads
        try:
            ref_depth, ref_filtered = kmer.estimate_overall_read_depth(sub, k, device=card)
        finally:
            kmer.counter_for = real
        if filtered.dense is not None or ref_filtered.dense is None:
            fail("phase 7a: estimate_overall_read_depth did not take the counters asked for")
        path_depths = [kmer.estimate_depth_for_reads(filtered, p) for p in path_seqs]
        ref_path_depths = [kmer.estimate_depth_for_reads(ref_filtered, p) for p in path_seqs]
        equal &= depth == ref_depth and path_depths == ref_path_depths
        del ref_filtered
        torch.cuda.empty_cache()
        row = {
            "reads": n_reads, "n_codes": n_codes, "distinct": len(got.kmers), "cutoff": cutoff,
            "depth": depth, "path_depths": path_depths, "sorted_seconds": sorted_s,
            "sorted_peak_bytes": sorted_peak, "dense_seconds": dense_s, "dense_peak_bytes": dense_peak,
            "equal": bool(equal),
        }
        rows.append(row)
        print(
            f"phase 7a sorted k-mer counter (k={k}, {n_reads} reads, {n_codes} codes, "
            f"{len(got.kmers)} distinct): sorted {sorted_s:.4f} s (peak {sorted_peak} bytes), "
            f"dense {dense_s:.4f} s (peak {dense_peak} bytes), median of 3 after a warm-up; "
            f"cutoff {cutoff}, depth {depth}, path depths {path_depths}; equal to the dense table: {equal}"
        )
        if not equal:
            fail(f"phase 7a: the sorted counter differs from the dense table at {n_codes} codes")
    return {"k": k, "golden_tables": golden_tables, "main_tables": main_tables, "sizes": rows}


def graph_full_state(graph):
    """graph_state and the rest of what phase 7b holds equal: nodes'
    canonical tokens, readNodeDirections, readNodePositions, short reads."""
    nodes, edges, read_nodes = graph_state(graph)
    return (
        nodes, edges, read_nodes,
        [n.tokens.tolist() for n in graph.get_nodes().values()],
        graph.get_readNodeDirections(), graph.get_readNodePositions(),
        graph.get_short_read_annotations(),
    )


def golden_cleaning_inputs(files):
    """What run_pipeline hands build_and_correct_graph for the seed-7
    isolate of phase 3: gene calls and positions, FASTQ content, genes of
    interest, per-k mean node coverages and the coverage trough of an
    initial build on the CPU."""
    from amira_tpu_torch.graph_utils import (
        build_graph, estimate_min_path_coverage, get_overall_mean_node_coverages,
    )
    from amira_tpu_torch.io import parse_fastq
    from amira_tpu_torch.preprocess import (
        load_species_specific_files, process_pandora_json, process_reference_alleles,
    )
    from amira_tpu_torch.vocab import GeneVocab

    fasta, _, _, _ = load_species_specific_files(
        "Escherichia_coli", files["amr_fasta"], files["amr_calls"], files["core_genes"],
        files["plasmid_genes"],
    )
    _, genes_of_interest = process_reference_alleles(fasta, False)
    reads, goi, positions = process_pandora_json(files["calls"], genes_of_interest, files["positions"])
    reads = dict(sorted(reads.items()))
    graph = build_graph(reads, 3, positions, GeneVocab(), device="cpu")
    try:
        min_cov = estimate_min_path_coverage(graph.get_all_node_coverages())
    except (ValueError, IndexError):
        min_cov = 10
    return (reads, positions, parse_fastq(files["fastq"]), goi,
            get_overall_mean_node_coverages(graph), min_cov)


def run_uncached_build(initial, golden_files, device):
    """Phase 7b: the graph build without a cache (`GeneMerGraph._build`,
    eager, its tables grouped on the device) on the card. Phase 4's initial
    calls at k = 3, built twice on the card (first and second call timed)
    and once on the CPU, and the first UNCACHED_READS reads at k = 5 and 7
    on both: each graph must equal the CPU's in full (graph_full_state).
    Then `build_and_correct_graph(cache=None)` on phase 3's seed-7 isolate
    on the card and on the CPU: the corrected calls, positions, chosen k
    and short reads must be equal."""
    import copy

    import torch

    from amira_tpu_torch import resolve_device
    from amira_tpu_torch.graph import GeneMerGraph
    from amira_tpu_torch.ops import graph_tables
    from amira_tpu_torch.pipeline import build_and_correct_graph
    from amira_tpu_torch.vocab import GeneVocab

    card = resolve_device(device + ":0")
    reads, positions = initial[0], initial[1]
    rows = []
    for k, n in ((3, None), (5, UNCACHED_READS), (7, UNCACHED_READS)):
        part = reads if n is None else dict(list(reads.items())[:n])
        build = lambda dev: GeneMerGraph(part, k, positions, vocab=GeneVocab(), device=dev)  # noqa: E731, B023
        runs = graph_tables.DEVICE_RUNS[card.type]
        on_card, first_s = card_timed(lambda: build(card))  # noqa: B023
        again, again_s = card_timed(lambda: build(card))  # noqa: B023
        on_cpu, cpu_s = card_timed(lambda: build("cpu"))  # noqa: B023
        state = graph_full_state(on_card)
        equal = (
            len(state[0]) > 0 and not on_card.is_lazy and on_card.lazy_tables() is None
            and graph_tables.DEVICE_RUNS[card.type] == runs + 2
            and state == graph_full_state(on_cpu) and state == graph_full_state(again)
        )
        row = {"k": k, "reads": len(part), "genes": sum(len(g) for g in part.values()),
               "nodes": len(state[0]), "edges": len(state[1]), "first_seconds": first_s,
               "again_seconds": again_s, "cpu_seconds": cpu_s, "equal": bool(equal)}
        rows.append(row)
        print(
            f"phase 7b build without a cache (k={k}, {row['reads']} reads, {row['genes']} genes, "
            f"{row['nodes']} nodes, {row['edges']} edges): on {card} {first_s:.3f} s (again "
            f"{again_s:.3f} s), on the CPU {cpu_s:.3f} s; eager and equal to the CPU's: {equal}"
        )
        if not equal:
            fail(f"phase 7b: the build without a cache at k = {k} differs between the card and the CPU")
        del on_card, again, on_cpu
    inputs = golden_cleaning_inputs(golden_files)
    corrected = {}
    for dev in (card, "cpu"):
        reads7, pos7, fastq, goi, coverages, min_cov = copy.deepcopy(inputs)
        short_reads, short_pos = {}, {}
        t0 = time.time()
        result = build_and_correct_graph(
            reads7, pos7, 3, fastq, os.path.join(WORK, "uncached", str(dev)), False, coverages, 1,
            short_reads, short_pos, goi, min_cov, True, GeneVocab(), None, device=dev,
        )
        torch.cuda.synchronize()
        corrected[str(dev)] = (result, short_reads, short_pos, time.time() - t0)
    got, *_, card_s = corrected[str(card)]
    cpu_s = corrected["cpu"][3]
    equal = corrected[str(card)][:3] == corrected["cpu"][:3]
    print(
        f"phase 7b build_and_correct_graph(cache=None) on the seed-7 isolate: on {card} "
        f"{card_s:.3f} s, on the CPU {cpu_s:.3f} s; k = {got[2]}, {len(got[0])} reads; "
        f"corrected calls equal: {equal}"
    )
    if not equal:
        fail("phase 7b: build_and_correct_graph(cache=None) differs between the card and the CPU")
    return {"builds": rows, "correct_card_seconds": card_s, "correct_cpu_seconds": cpu_s,
            "chosen_k": got[2]}


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
    t_start = time.time()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"phase 1 device: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    shutil.rmtree(WORK, ignore_errors=True)
    scale_isolate = start_scale_isolate(args.reads)
    t0 = time.time()
    lib = sw_batch.build()
    print(f"phase 1 build: {os.path.relpath(lib, ROOT)} in {time.time() - t0:.2f} s")
    ptxas_path = os.path.join(os.path.dirname(lib), "sw_batch_ptxas.txt")
    with open(ptxas_path) as f:
        for line in f:
            if "Used" in line or "spill" in line:
                print(f"phase 1 ptxas: {line.strip()}")
    clock = []

    def lap(label):
        clock.append([label, time.time() - t_start])
        print(f"clock: {label} done at {clock[-1][1]:.1f} s")

    lap("phase 1")
    timed, sweep = check_kernels(device)
    lap("phase 2")
    golden_files, golden_tables = check_golden(device)
    lap("phase 3")
    files = wait_scale_isolate(scale_isolate, args.reads)
    summary, scale_out = run_main_path(files, device)
    lap("phase 4")
    w512_edges = check_w512_edges(device, ptxas_report(ptxas_path))
    lap("phase 5a edges")
    sam = run_sam_route(files, SAM_READS, device)
    lap("phase 5b")
    asm = run_assemble_paths(scale_out, device)
    lap("phase 5c")
    w512_timed = check_w512_at(tuple(asm["largest_w512"]), device)
    lap("phase 5a at 5c's shape")
    modes = check_modes(device)
    lap("phase 5d")
    batch_runs = run_batch_phase(files, scale_out, device)
    lap("phase 6a")
    dist, initial = run_dist_build(files, device)
    lap("phase 6b")
    table_meshes = run_table_meshes(initial, device)
    lap("phase 6c")
    all_seqs = read_sequences(files)
    dist_kmer = run_dist_kmer(all_seqs, device)
    lap("phase 6d")
    two_procs = run_two_processes(initial, all_seqs[:SAM_READS], device)
    first_seqs = all_seqs[:SORTED_READS]
    del all_seqs
    lap("phase 6e")
    graft = run_graft_entry(initial, device)
    lap("phase 6f")
    main_tables = {"sorted": summary["sorted_tables"], "dense": summary["dense_tables"]}
    sorted_kmer = run_sorted_kmer(
        first_seqs, os.path.join(scale_out, "AMR_allele_fastqs", "path_reads"), golden_tables,
        main_tables, device,
    )
    del first_seqs
    lap("phase 7a")
    uncached = run_uncached_build(initial, golden_files, device)
    lap("phase 7b")

    kernels = []
    for name, replaces in (
        ("sw_dp", "amira_tpu/ops/pallas_sw_batch.py:51"),
        ("sw_traceback", "amira_tpu/ops/align.py:390"),
    ):
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "amira_tpu_torch/csrc/sw_batch.cu",
            "replaces": replaces,
            "launches": summary["launches"][name],
            **timed[MAIN_SHAPE][name],
            "launches_sam_route": sam["launches"][name],
            "launches_assemble_paths": asm["launches"][name],
            "launches_batch": {k: r["launches"][name] for k, r in batch_runs.items()},
            "w512": {
                **w512_timed[name],
                "edge_max_abs_err": w512_edges["edge_max_abs_err"][name],
                "ptxas": w512_edges["ptxas"][
                    "sw_dp_kernel<16>" if name == "sw_dp" else "sw_traceback_kernel<512>"
                ],
            },
        })
    kernels[1]["w512"]["random_max_abs_err"] = w512_edges["edge_max_abs_err"]["sw_traceback_random"]
    os.makedirs(os.path.dirname(SUMMARY), exist_ok=True)
    with open(SUMMARY, "w") as f:
        json.dump(
            {"card": card, "kernels": kernels, "timed": list(timed.values()), "sweep": sweep,
             "main_path": summary, "sam_route": sam, "assemble_paths": asm, "modes": modes,
             "batch": batch_runs, "dist_build": dist, "table_meshes": table_meshes,
             "dist_kmer": dist_kmer, "two_processes": two_procs, "graft_entry": graft,
             "sorted_kmer": sorted_kmer, "uncached_build": uncached, "clock": clock},
            f, indent=1,
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
