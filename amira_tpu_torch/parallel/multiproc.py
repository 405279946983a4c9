"""Multi-process runs of the distributed steps over `torch.distributed`.

Each process joins a process group through tcp://localhost:<port> and owns
SHARDS shards of its device. Two steps run with the process boundary
inside the mesh:

* the ("host", "data", "table") count step (`distgraph.
  make_distributed_genemer_step_3d`) at k = 3 with "host" on the process
  boundary: mesh (P, SHARDS / 2, 2), the hosts' partition tables
  all-gathered across the processes;
* the bin-sharded k-mer step (`distgraph.make_distributed_kmer_step`) at
  k = 15 (the copy-number estimate's) with its bins spread over every
  shard of every process (P * SHARDS shards); each process checks its own
  bin range against the single-process k-mer counter
  (`ops/kmer.KmerCounter`) on its device.

Each process writes a JSON result (and its count table as .npz) for the
parent to compare. The backend is the caller's: "nccl" needs a card of its
own for each rank and raises otherwise; "gloo" copies the tables that cross
the process boundary to the host, and also serves ranks that share one card
or run on the CPU. Nothing switches backend on its own.

    python -m amira_tpu_torch.parallel.multiproc RANK WORLD PORT OUT_DIR \\
        --backend gloo --devices cuda:0,cuda:0 [--tokens reads.npz --seqs reads.txt]

Without --tokens and --seqs each process makes the inputs of the JAX
package's two-process test (tests/dcn_worker.py) from their seeds, with
that test's k and capacities.
`run_workers` starts the processes (new interpreters: never forked) and
waits for them with a timeout.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops.hashing import splitmix64
from . import distgraph
from .mesh import CROSS_PROCESS_BYTES, Mesh

SHARDS = 4  # shards of each process's device


def check_backend(backend: str, devices) -> None:
    """Raise for a backend the ranks' devices cannot serve: "nccl" needs a
    distinct CUDA device for each rank."""
    devices = [torch.device(d) for d in devices]
    if backend == "nccl":
        if any(d.type != "cuda" for d in devices):
            raise ValueError("backend 'nccl' needs a CUDA device for every rank")
        if len({(d.type, d.index or 0) for d in devices}) < len(devices):
            raise ValueError(
                "backend 'nccl' needs a card of its own for each rank; ranks "
                f"share one in {[str(d) for d in devices]} (use 'gloo')"
            )
    elif backend != "gloo":
        raise ValueError(f"unsupported backend {backend!r} (expected 'nccl' or 'gloo')")


def dcn_inputs():
    """The JAX package's two-process test inputs (tests/dcn_worker.py):
    (tokens, lengths, k, capacity) for the count step and (sequences, k)
    for the k-mer step."""
    rng = np.random.RandomState(7)
    R, L, k = 64, 12, 3
    tokens = (
        rng.randint(1, 30, size=(R, L)).astype(np.int32)
        * rng.choice([-1, 1], size=(R, L)).astype(np.int32)
    )
    lengths = rng.randint(k, L + 1, size=(R,)).astype(np.int32)
    rng2 = np.random.RandomState(5)
    bases = np.array(list("ACGTN"))
    seqs = [
        "".join(rng2.choice(bases, size=int(rng2.randint(30, 400)),
                            p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        for _ in range(40)
    ]
    seqs.append("".join(rng2.choice(bases[:4], size=9000)))
    return (tokens, lengths, k, 1 << 10), (seqs, 7)


def bins_digest(table, lo: int, chunk: int = 1 << 24):
    """[sum, nonzero bins, sum of count * splitmix64(bin) mod 2^64] of a run
    of count bins starting at bin `lo`: equal digests of two bin ranges mean
    equal counts (up to a 2^-64 chance)."""
    total = nnz = mix = 0
    for s in range(0, table.shape[0], chunk):
        v = table[s : s + chunk].to(torch.int64)
        idx = torch.arange(lo + s, lo + s + v.shape[0], dtype=torch.int64, device=v.device)
        total += int(v.sum())
        nnz += int((v != 0).sum())
        mix = (mix + int((splitmix64(idx) * v).sum())) % (1 << 64)
    return [total, nnz, mix]


def _counter_range(seqs, k: int, device, lo: int, hi: int):
    """Bins [lo, hi) of the single-process counter's table (`KmerCounter`:
    the dense table, or a sorted or host (k-mer, count) table scattered
    into `device` memory), bin 4^k (invalid windows) and the padding past
    it zero."""
    from ..ops.kmer import KmerCounter

    counter = KmerCounter.from_sequences(seqs, k, device=device)
    n_bins = 4**k
    out = torch.zeros(hi - lo, dtype=torch.int32, device=device)
    top = min(hi, n_bins)
    if counter.dense is not None:
        if top > lo:
            out[: top - lo] = counter.dense[lo:top]
        return out
    sel = (counter.kmers >= lo) & (counter.kmers < top)
    idx = torch.from_numpy(counter.kmers[sel].astype(np.int64) - lo).to(out.device)
    out[idx] = torch.from_numpy(counter.counts[sel].astype(np.int32)).to(out.device)
    return out


def run_process(rank, world, port, out_dir, backend, devices, tokens=None, lengths=None,
                seqs=None):
    """One process of the group: both steps, its checks, its result file.
    Returns the result dict."""
    import datetime

    import torch.distributed as dist

    check_backend(backend, devices)
    device = torch.device(devices[rank])
    k, capacity, kmer_k = 3, 1 << 16, 15
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=600),
    )
    try:
        group = dist.group.WORLD
        if tokens is None:
            (tokens, lengths, k, capacity), (seqs, kmer_k) = dcn_inputs()
        result = {"rank": rank, "world": world, "backend": backend, "device": str(device),
                  "shards": SHARDS}

        mesh = Mesh([[[device] * 2] * (SHARDS // 2)], ("host", "data", "table"), group=group)
        dist.barrier()
        t0 = time.perf_counter()
        keys, counts, total = distgraph.distributed_node_counts_3d(
            tokens, lengths, k, mesh, capacity
        )
        result["count_seconds"] = time.perf_counter() - t0
        table_path = os.path.join(out_dir, f"counts_{rank}.npz")
        np.savez(table_path, keys=keys, counts=counts)
        result.update(total=total, n_keys=int(len(keys)), counts_file=table_path,
                      count_bytes_sent=CROSS_PROCESS_BYTES[0])

        from ..ops.kmer import _concat_codes

        kmesh = Mesh([device] * SHARDS, ("kdata",), group=group)
        words, bad, chunk = distgraph.kmer_rows(_concat_codes(seqs), kmer_k, kmesh.size)
        step = distgraph.make_distributed_kmer_step(kmesh, kmer_k, chunk)
        sent_before = CROSS_PROCESS_BYTES[0]
        dist.barrier()
        t0 = time.perf_counter()
        mine = step(words, bad)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        result["kmer_seconds"] = time.perf_counter() - t0
        result["kmer_bytes_sent"] = CROSS_PROCESS_BYTES[0] - sent_before
        _Tp, B = distgraph.kmer_layout(kmer_k, kmesh.size)
        lo = kmesh.offset * B
        hi = lo + len(mine) * B
        ranges = [[g * B, (g + 1) * B] for g, _ in kmesh.local_shards()]
        result["kmer_bins"] = ranges
        result["kmer_digests"] = [bins_digest(s, r[0]) for s, r in zip(mine, ranges)]
        expected = _counter_range(seqs, kmer_k, device, lo, hi)
        got = torch.cat([s.to(device) for s in mine])
        # bin 4^k counts invalid windows (padding included): not the counter's
        keep = torch.arange(lo, hi, device=device) != 4**kmer_k
        result["kmer_matches_counter"] = bool(torch.equal(got[keep], expected[keep]))
        result["kmer_bins_covered"] = int(keep.sum())
        del expected, got, mine
        with open(os.path.join(out_dir, f"result_{rank}.json"), "w") as f:
            json.dump(result, f)
        dist.barrier()
        return result
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_workers(out_dir, backend, devices, tokens_file=None, seqs_file=None, timeout=600):
    """Start one process per entry of `devices` (rank r on devices[r]),
    each a new interpreter running this module on the inputs in
    `tokens_file` and `seqs_file` (main's --tokens and --seqs; both or
    neither), and wait for all of them. Returns their result dicts in rank
    order; raises (with the workers' stderr) if one fails or the timeout
    passes, killing the rest."""
    check_backend(backend, devices)
    os.makedirs(out_dir, exist_ok=True)
    world, port = len(devices), _free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    argv = ["--backend", backend, "--devices", ",".join(str(d) for d in devices)]
    if tokens_file:
        argv += ["--tokens", tokens_file, "--seqs", seqs_file]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "amira_tpu_torch.parallel.multiproc",
             str(r), str(world), str(port), out_dir] + argv,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        for r in range(world)
    ]
    deadline = time.time() + timeout
    errs = [""] * world
    try:
        for r, p in enumerate(procs):
            _out, errs[r] = p.communicate(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for r, p in enumerate(procs):
            errs[r] = errs[r] or p.communicate()[1]
        raise TimeoutError(
            f"multi-process run passed its {timeout} s timeout:\n"
            + "\n".join(f"rank {r} stderr:\n{e[-3000:]}" for r, e in enumerate(errs))
        ) from None
    if any(p.returncode for p in procs):
        raise RuntimeError(
            "a worker failed:\n" + "\n".join(
                f"rank {r} (exit {p.returncode}) stderr:\n{errs[r][-3000:]}"
                for r, p in enumerate(procs)
            )
        )
    results = []
    for r in range(world):
        with open(os.path.join(out_dir, f"result_{r}.json")) as f:
            results.append(json.load(f))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port", type=int)
    ap.add_argument("out_dir")
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--devices", required=True, help="each rank's device, comma-separated")
    ap.add_argument("--tokens", help=".npz with tokens (R, L) and lengths (R,)")
    ap.add_argument("--seqs", help="text file of DNA sequences, one per line")
    args = ap.parse_args(argv)
    tokens = lengths = seqs = None
    if (args.tokens is None) != (args.seqs is None):
        ap.error("give both --tokens and --seqs, or neither")
    if args.tokens:
        with np.load(args.tokens) as z:
            tokens, lengths = z["tokens"], z["lengths"]
        with open(args.seqs) as f:
            seqs = f.read().split()
    run_process(
        args.rank, args.world, args.port, args.out_dir, args.backend,
        args.devices.split(","), tokens, lengths, seqs,
    )


if __name__ == "__main__":
    main()
