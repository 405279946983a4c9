"""amira-tpu-torch: the PyTorch/CUDA port of the amira-tpu AMR-gene engine.

This package runs every single-isolate feature of `amira_tpu` (pandora
JSON or SAM gene calls, or pandora map, + FASTQ reads or an assembly ->
gene-mer graph -> cleaning -> AMR path clustering -> allele polishing ->
copy number -> `amira_results.tsv`, with the --meta, --promoter-mutations,
--assemble-paths and --debug options) with PyTorch on an NVIDIA GPU, and
with PyTorch's CPU ops for testing; the initial and final graph builds of
an isolate spread over several devices (--dist-build,
`parallel/distgraph.py`), and a batch of isolates runs in one process, one
CUDA stream per worker thread (`batch.py`). Module names and layout mirror
`amira_tpu/`, so each module here has its counterpart there.

What moved and how:

* Host-only modules (`vocab`, `io`, `sketch`, `stree`, `graph_cache`,
  `correct`, `clean`, `bubbles`, `bubble_view`, `cluster`,
  `ops/host_tables`, `ops/consensus`, `preprocess`, `assembly`,
  `promoters`) and the C source of the host I/O helper
  (`native/_fastio.c`) are copies of their `amira_tpu` counterparts with
  only the package-internal import lines changed and `device` passed down
  to the aligner; `bubbles` keeps its stage seconds per thread, and
  `_fastio.c` reads a FASTQ whole only up to a size ceiling (256 MiB of
  file) and streams larger ones. They are copied rather than imported because importing any
  `amira_tpu.*` module runs `amira_tpu/__init__.py`, which imports JAX and
  switches on 64-bit mode for the whole process.
* Device code is torch: gene-mer window hashing and the tables of a
  graph build without a cache (`ops/hashing`, `ops/graph_tables`), the
  sorted and dense k-mer counters (`ops/kmer`), and the banded
  Smith-Waterman aligner, whose DP and traceback are hand-written CUDA
  kernels (`csrc/sw_batch.cu`, bound by `ops/sw_batch`).
* The device is always explicit: `--device` (cuda, cuda:N or cpu) on the
  CLI, a `device` argument below it. Asking for a CUDA device that is not
  visible raises. Kernel launches make their tensors' device current
  (`ops/sw_batch._launch`), so any thread can drive any card.

One thing is read from the JAX package's directory by path, never by
import: the species asset pack (`amira_tpu/assets/<species>/`), which is
data, not code.
"""

from __future__ import annotations

import os

__version__ = "0.1.0"

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
# the JAX reference package, a sibling directory: read by path only
REFERENCE_PACKAGE_DIR = os.path.join(os.path.dirname(PACKAGE_DIR), "amira_tpu")
# build outputs (native helper, CUDA kernels); listed in .gitignore
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")


def resolve_device(name) -> "torch.device":  # noqa: F821
    """torch.device for a `--device` value ("cpu", "cuda" or "cuda:N");
    raises for cuda without a GPU and for a CUDA index that is not visible
    (the port never falls back to the CPU on its own)."""
    import torch

    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {name!r} (expected cuda, cuda:N or cpu)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} was requested but "
                "torch.cuda.is_available() is False; pass --device cpu to run "
                "on the CPU"
            )
        n = torch.cuda.device_count()
        if dev.index is not None and dev.index >= n:
            raise RuntimeError(
                f"device {str(name)!r} was requested but only {n} cuda "
                "device(s) are visible"
            )
    return dev


def visible_devices(name) -> list:
    """The torch devices a `--device` value spans: every visible cuda:N for
    "cuda", the one device for "cuda:N" or "cpu". Raises as resolve_device
    does."""
    import torch

    dev = resolve_device(name)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]
