"""Banded two-piece-affine Smith-Waterman DP + traceback for a batch of jobs.

The counterpart of `amira_tpu/ops/pallas_sw_batch.py` (and of the XLA twin
`_batched_sw_cigar` in `amira_tpu/ops/align.py`, which defines the same
semantics). Two kernels, hand-written in CUDA C++ for sm_90a in
`amira_tpu_torch/csrc/sw_batch.cu` (see its header for the design and what
bounds it on the card):

* `sw_dp` replaces `_sw_batch_kernel_body` (pallas_sw_batch.py:51-212): the
  banded DP, one traceback byte per cell, and each job's best cell.
* `sw_traceback` replaces `_traceback_batch` (align.py:390-486): the walk
  from the best cell that emits 2-bit-packed =/X/I/D ops.

The kernels are compiled with nvcc into a shared library with a plain C
interface at first use (`build()`), into `amira_tpu_torch/_build/`, and are
called through ctypes on PyTorch's current stream. A failed build raises
with nvcc's output.

Beside each kernel is its plain PyTorch version (`sw_dp_reference`,
`sw_traceback_reference`): a Python loop over query rows on (B, W) tensors
with `torch.cummax` for the deletion recurrences, and a vectorised walk. The
wrappers use the plain versions only for tensors on the CPU; for CUDA
tensors they launch the kernels, with the tensors' device current and on
its current stream (`_launch`), or raise. `LAUNCHES` counts kernel launches
and `DP_SHAPES` counts sw_dp launches by (B, Lq, W), over the process (the
aligner's `align.kernels` spans count each isolate's own launches and their
work); `traceback_restages()` reads the traceback kernel's count of
re-stages (tiles it had to stage and wait for because a walk left the
window of lanes it was reading).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

from .. import BUILD_DIR, PACKAGE_DIR
from .align import (
    GAP_EXT,
    GAP_EXT2,
    GAP_OPEN,
    GAP_OPEN2,
    MATCH,
    MISMATCH,
    NEG,
)

_SRC = os.path.join(PACKAGE_DIR, "csrc", "sw_batch.cu")

# kernel launches by the wrappers below (never by the plain versions), and
# sw_dp launches by (B, Lq, W): over the process, so a batch's isolates sum
# here
LAUNCHES = {"sw_dp": 0, "sw_traceback": 0}
DP_SHAPES: collections.Counter = collections.Counter()
_count_lock = threading.Lock()


def _count_launch(name: str, dp_shape=None):
    with _count_lock:
        LAUNCHES[name] += 1
        if dp_shape is not None:
            DP_SHAPES[dp_shape] += 1


# band widths both kernels are instantiated for (W = 32 * S band lanes, S per
# thread of a warp): the aligner's 256, the assembly's polishing band 512
DP_WIDTHS = (64, 128, 256, 512)

# op codes of the packed traceback (2 bits each, 4 per byte, step order)
OP_EQ, OP_X, OP_I, OP_D = 0, 1, 2, 3


def tb_steps(Lq: int, W: int) -> int:
    """Step bound of the traceback walk and width (x4) of its packed output:
    the JAX package's `_tb_steps` (every query row consumed plus every band
    lane crossed, rounded to 4) rounded up to its 256-step chunk."""
    s = (2 * Lq + W + 2 + 3) & ~3
    return (s + 255) // 256 * 256


# ------------------------------------------------------------------ build

_lib = None
_build_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build() -> str:
    """Compile csrc/sw_batch.cu (once per source content: the library is
    named by the source's digest) and load it, once per process; returns the
    library path. Raises with nvcc's output on failure. The wrappers call it
    before every launch, so after the first call it touches no file. Threads
    that call it together build once: the first holds `_build_lock`, and
    nvcc writes to a file named by process and thread."""
    if _lib is not None:
        return _lib._name
    with _build_lock:
        return _build_locked()


def _build_locked() -> str:
    global _lib
    if _lib is not None:
        return _lib._name
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    so = os.path.join(BUILD_DIR, f"libsw_batch_{digest}.so")
    if not os.path.exists(so):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [
            _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", tmp, _SRC,
        ]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)
        with open(os.path.join(BUILD_DIR, "sw_batch_ptxas.txt"), "w") as f:
            f.write(proc.stderr)
    lib = ctypes.CDLL(so)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sw_dp_launch.argtypes = [p, p, p, p, i, i, i, i, p, p, p, p, p, p]
    lib.sw_dp_launch.restype = ctypes.c_int
    lib.sw_traceback_launch.argtypes = [p] * 6 + [i, i, i, i] + [p] * 5
    lib.sw_traceback_launch.restype = ctypes.c_int
    lib.sw_traceback_restages.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), i]
    lib.sw_traceback_restages.restype = ctypes.c_int
    _lib = lib
    return so


def _check(t: torch.Tensor, name: str, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _launch(dev: torch.device, launcher, *args) -> int:
    """Calls a ctypes launcher with `args` and `dev`'s current stream, with
    `dev` as the calling thread's current CUDA device: the runtime launches
    on the current device whatever stream it is given, so without the guard
    a launch for cuda:1 from a thread whose current device is cuda:0 would
    go to the wrong card. Returns the launcher's CUDA error code."""
    with torch.cuda.device(dev):
        return launcher(*args, torch.cuda.current_stream(dev).cuda_stream)


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


# ------------------------------------------------------------------ DP


def sw_dp(qs, rs, qlens, dlos, W: int):
    """Banded DP. qs (B, Lq) uint8 query codes (0-3, 255 invalid; padding
    past qlen), rs (B, Lr) uint8 reference codes with the real reference at
    offset W + Lq and code 4 as padding, qlens/dlos (B,) int32.

    Returns tb (B, Lq, W) uint8 and best, bi, bw, bs (B,) int32. Traceback
    rows at or past a job's qlen are unspecified (never read).

    The kernel takes W in DP_WIDTHS, and Lq with 2*Lq < 2^(29 - log2 W)
    (Lq < 2^20 at W = 256, Lq < 2^19 = 524,288 at W = 512): its row maximum
    packs the score into 32 - log2(W) - 3 bits of a key. It raises
    ValueError past either limit."""
    if qs.device.type == "cpu":
        return sw_dp_reference(qs, rs, qlens, dlos, W)
    if qs.device.type != "cuda":
        raise ValueError(f"sw_dp: unsupported device {qs.device}")
    if W not in DP_WIDTHS:
        raise ValueError(f"sw_dp: W must be one of {DP_WIDTHS}, got {W}")
    B, Lq = qs.shape
    if 2 * Lq >= 1 << (32 - (W.bit_length() - 1) - 3):
        raise ValueError(f"sw_dp: Lq={Lq} too long for the kernel's score key at W={W}")
    Lr = rs.shape[1]
    dev = qs.device
    _check(qs, "qs", torch.uint8, (B, Lq), dev)
    _check(rs, "rs", torch.uint8, (B, Lr), dev)
    _check(qlens, "qlens", torch.int32, (B,), dev)
    _check(dlos, "dlos", torch.int32, (B,), dev)
    build()
    tb = torch.empty((B, Lq, W), dtype=torch.uint8, device=dev)
    best, bi, bw, bs = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(4))
    if B == 0:
        return tb, best, bi, bw, bs
    err = _launch(
        dev, _lib.sw_dp_launch, qs.data_ptr(), rs.data_ptr(), qlens.data_ptr(),
        dlos.data_ptr(), B, Lq, Lr, W, tb.data_ptr(), best.data_ptr(),
        bi.data_ptr(), bw.data_ptr(), bs.data_ptr(),
    )
    _raise_on(err, "sw_dp")
    _count_launch("sw_dp", (B, Lq, W))
    return tb, best, bi, bw, bs


def _first_index(cond: torch.Tensor, vals: list, default: int):
    """Nested `>=` selection as a value: vals[0] where cond[0], else vals[1]
    where cond[1], ..., else default."""
    out = torch.full_like(cond[0], default, dtype=torch.int32)
    for c, v in zip(reversed(cond), reversed(vals)):
        out = torch.where(c, v, out)
    return out


def sw_dp_reference(qs, rs, qlens, dlos, W: int):
    """Plain PyTorch version of sw_dp (the JAX package's
    `_banded_sw_batch_core` row for row). Works on any device."""
    B, Lq = qs.shape
    Lr = rs.shape[1]
    dev = qs.device
    i32 = torch.int32
    neg = torch.tensor(NEG, dtype=i32, device=dev)
    match = torch.tensor(MATCH, dtype=i32, device=dev)
    mismatch = torch.tensor(MISMATCH, dtype=i32, device=dev)
    w_idx = torch.arange(W, dtype=i32, device=dev)[None, :]
    # per-job reference window: rsh[b, t] = rs[b, t + dlo + W + Lq]
    gidx = dlos.long()[:, None] + torch.arange(Lq + W, device=dev)[None, :] + (W + Lq)
    inb = (gidx >= 0) & (gidx < Lr)
    rsh = torch.where(inb, rs.gather(1, gidx.clamp(0, max(Lr - 1, 0))), 4).to(i32)
    q32 = qs.to(i32)
    qlens_c = qlens.to(i32)[:, None]
    negcol = torch.full((B, 1), NEG, dtype=i32, device=dev)

    def shift_up(x):  # lane w+1 -> w
        return torch.cat([x[:, 1:], negcol], dim=1)

    def shift_left(x):  # lane w-1 -> w
        return torch.cat([negcol, x[:, :-1]], dim=1)

    M = torch.zeros((B, W), dtype=i32, device=dev)
    I = torch.full((B, W), NEG, dtype=i32, device=dev)
    D, I2, D2 = I.clone(), I.clone(), I.clone()
    best = torch.zeros(B, dtype=i32, device=dev)
    bi = torch.full((B,), -1, dtype=i32, device=dev)
    bw = torch.full((B,), -1, dtype=i32, device=dev)
    bs = torch.zeros(B, dtype=i32, device=dev)
    tb = torch.zeros((B, Lq, W), dtype=torch.uint8, device=dev)
    n_rows = int(qlens.max()) if B else 0
    for i in range(min(n_rows, Lq)):
        rwin = rsh[:, i : i + W]
        in_ref = rwin != 4
        eq = rwin == q32[:, i : i + 1]
        g34 = torch.maximum(I2, D2)
        g234 = torch.maximum(D, g34)
        gap_best = torch.maximum(I, g234)
        prev_best = torch.maximum(M, gap_best)
        m_pred = _first_index(
            [M >= gap_best, I >= g234, D >= g34, I2 >= D2], [1, 2, 3, 4], 5
        )
        M_diag = prev_best.clamp(min=0) + torch.where(eq, match, mismatch)
        m_bits = torch.where((M_diag > 0) & (prev_best > 0), m_pred, 0)
        M_cur = torch.where(in_ref, M_diag.clamp(min=0), neg)
        M_up, I_up, I2_up = shift_up(M), shift_up(I), shift_up(I2)
        I_open, I_ext = M_up - GAP_OPEN, I_up - GAP_EXT
        I2_open, I2_ext = M_up - GAP_OPEN2, I2_up - GAP_EXT2
        i_bits = (I_ext >= I_open).to(i32) << 3
        i2_bits = (I2_ext >= I2_open).to(i32) << 5
        I_cur = torch.where(in_ref, torch.maximum(I_open, I_ext), neg)
        I2_cur = torch.where(in_ref, torch.maximum(I2_open, I2_ext), neg)
        A_shift = shift_left(torch.cummax(M_cur + w_idx * GAP_EXT, dim=1).values)
        D_un = torch.maximum(A_shift - GAP_OPEN - (w_idx - 1) * GAP_EXT, neg)
        A2_shift = shift_left(torch.cummax(M_cur + w_idx * GAP_EXT2, dim=1).values)
        D2_un = torch.maximum(A2_shift - GAP_OPEN2 - (w_idx - 1) * GAP_EXT2, neg)
        M_left = shift_left(M_cur)
        d_bits = ((shift_left(D_un) - GAP_EXT) >= (M_left - GAP_OPEN)).to(i32) << 4
        d2_bits = ((shift_left(D2_un) - GAP_EXT2) >= (M_left - GAP_OPEN2)).to(i32) << 6
        D_cur = torch.where(in_ref, D_un, neg)
        D2_cur = torch.where(in_ref, D2_un, neg)
        live = i < qlens_c
        M = torch.where(live, M_cur, neg)
        I = torch.where(live, I_cur, neg)
        D = torch.where(live, D_cur, neg)
        I2 = torch.where(live, I2_cur, neg)
        D2 = torch.where(live, D2_cur, neg)
        tb[:, i, :] = (
            m_bits | i_bits | d_bits | i2_bits | d2_bits | (eq.to(i32) << 7)
        ).to(torch.uint8)
        h34 = torch.maximum(I2, D2)
        h234 = torch.maximum(D, h34)
        gap_cur = torch.maximum(I, h234)
        row_state = _first_index(
            [M >= gap_cur, I >= h234, D >= h34, I2 >= D2], [0, 1, 2, 3], 4
        )
        row_vals = torch.maximum(M, gap_cur)
        rv, rw = row_vals.max(dim=1)  # first maximal lane
        rw = rw.to(i32)
        upd = rv > best
        best = torch.where(upd, rv, best)
        bi = torch.where(upd, i, bi)
        bw = torch.where(upd, rw, bw)
        bs = torch.where(upd, row_state.gather(1, rw.long()[:, None])[:, 0], bs)
    return tb, best, bi, bw, bs


# ------------------------------------------------------------ traceback


def sw_traceback(tb, best, bi, bw, bs, dlos, W: int):
    """Walk each job's traceback from (bi, bw, bs). Returns packed
    (B, tb_steps(Lq, W) // 4) uint8 (op t of the walk at byte t // 4, bits
    2*(t % 4); zero past the walk), and n_steps, q0, r0 (B,) int32 with
    r0 = q0 + dlo + final lane. A job with bi < 0 or best <= 0 is done at
    once.

    The kernel takes W in DP_WIDTHS and a tb whose data is 16-byte aligned
    (it copies 16-byte chunks of rows); it raises ValueError otherwise."""
    if tb.device.type == "cpu":
        return sw_traceback_reference(tb, best, bi, bw, bs, dlos, W)
    if tb.device.type != "cuda":
        raise ValueError(f"sw_traceback: unsupported device {tb.device}")
    if W not in DP_WIDTHS:
        raise ValueError(f"sw_traceback: W must be one of {DP_WIDTHS}, got {W}")
    B, Lq, _ = tb.shape
    dev = tb.device
    _check(tb, "tb", torch.uint8, (B, Lq, W), dev)
    if tb.data_ptr() % 16:
        raise ValueError("sw_traceback: tb must be 16-byte aligned")
    for name, t in (("best", best), ("bi", bi), ("bw", bw), ("bs", bs), ("dlos", dlos)):
        _check(t, name, torch.int32, (B,), dev)
    build()
    max_steps = tb_steps(Lq, W)
    packed = torch.empty((B, max_steps // 4), dtype=torch.uint8, device=dev)
    n_steps, q0, r0 = (torch.empty(B, dtype=torch.int32, device=dev) for _ in range(3))
    if B == 0:
        return packed, n_steps, q0, r0
    err = _launch(
        dev, _lib.sw_traceback_launch, tb.data_ptr(), best.data_ptr(),
        bi.data_ptr(), bw.data_ptr(), bs.data_ptr(), dlos.data_ptr(), B, Lq, W,
        max_steps, packed.data_ptr(), n_steps.data_ptr(), q0.data_ptr(),
        r0.data_ptr(),
    )
    _raise_on(err, "sw_traceback")
    _count_launch("sw_traceback")
    return packed, n_steps, q0, r0


def traceback_restages(reset: bool = False, device="cuda") -> int:
    """Re-stages of the sw_traceback kernel on `device` since the library
    was loaded or last reset: tiles a walk staged and waited for after its
    first, because it left the window of lanes it was reading. Waits for
    `device`'s current stream (the launches the count is to include), not
    for the card's other streams."""
    build()
    dev = torch.device(device)
    count = ctypes.c_ulonglong(0)
    with torch.cuda.device(dev):
        torch.cuda.current_stream(dev).synchronize()
        err = _lib.sw_traceback_restages(ctypes.byref(count), int(reset))
    if err != 0:
        raise RuntimeError(f"sw_traceback_restages: CUDA error {err}")
    return count.value


def sw_traceback_reference(tb, best, bi, bw, bs, dlos, W: int):
    """Plain PyTorch version of sw_traceback (the JAX package's
    `_traceback_batch`), vectorised over jobs. Works on any device."""
    B, Lq, _ = tb.shape
    dev = tb.device
    i32 = torch.int32
    S = tb_steps(Lq, W)
    pred_state = torch.tensor([0, 0, 1, 2, 3, 4, 0, 0], dtype=i32, device=dev)
    flat = tb.reshape(-1)
    base = torch.arange(B, device=dev, dtype=torch.int64) * (Lq * W)
    i, w, state = bi.to(i32).clone(), bw.to(i32).clone(), bs.to(i32).clone()
    done = (bi < 0) | (best <= 0)
    n = torch.zeros(B, dtype=i32, device=dev)
    ops = torch.zeros((S, B), dtype=torch.uint8, device=dev)
    for step in range(S):
        # the walk is finished for every job: the rest of `ops` stays 0
        if step % 64 == 0 and not bool((~done & (i >= 0)).any()):
            break
        live = ~done & (i >= 0)
        idx = base + i.clamp(0, Lq - 1).long() * W + w.clamp(0, W - 1).long()
        byte = flat[idx].to(i32)
        pred = byte & 7
        is_m, is_i, is_d, is_i2 = state == 0, state == 1, state == 2, state == 3
        is_ins = is_i | is_i2
        op = torch.where(
            is_m, torch.where((byte >> 7) & 1 == 1, OP_EQ, OP_X),
            torch.where(is_ins, OP_I, OP_D),
        )
        ext = torch.where(
            is_i, (byte >> 3) & 1,
            torch.where(is_d, (byte >> 4) & 1, torch.where(is_i2, (byte >> 5) & 1, (byte >> 6) & 1)),
        )
        nstate = torch.where(is_m, pred_state[pred.long()], torch.where(ext == 1, state, 0))
        di = (is_m | is_ins).to(i32)
        dw = torch.where(is_ins, 1, torch.where(is_d | (state == 4), -1, 0)).to(i32)
        ndone = done | (is_m & (pred == 0))
        i = torch.where(live, i - di, i)
        w = torch.where(live, w + dw, w)
        state = torch.where(live, nstate, state)
        done = torch.where(live, ndone, done)
        n = n + live.to(i32)
        ops[step] = torch.where(live, op, 0).to(torch.uint8)
    shifts = torch.arange(0, 8, 2, device=dev, dtype=i32)
    packed = (
        (ops.t().reshape(B, S // 4, 4).to(i32) << shifts).sum(dim=2).to(torch.uint8)
    )
    q0 = i + 1
    return packed, n, q0, q0 + dlos.to(i32) + w


# ---------------------------------------------------------------- fused


def sw_cigar(qs, rs, qlens, dlos, W: int):
    """DP + traceback; the 7 outputs of the JAX package's
    `_batched_sw_cigar` / `pallas_sw_cigar`: packed, n_steps, q0, r0, best,
    bi, bw. Kernels for CUDA tensors, plain versions for CPU tensors."""
    tb, best, bi, bw, bs = sw_dp(qs, rs, qlens, dlos, W)
    packed, n_steps, q0, r0 = sw_traceback(tb, best, bi, bw, bs, dlos, W)
    return packed, n_steps, q0, r0, best, bi, bw


def sw_cigar_reference(qs, rs, qlens, dlos, W: int):
    """Plain PyTorch version of sw_cigar, on any device."""
    tb, best, bi, bw, bs = sw_dp_reference(qs, rs, qlens, dlos, W)
    packed, n_steps, q0, r0 = sw_traceback_reference(tb, best, bi, bw, bs, dlos, W)
    return packed, n_steps, q0, r0, best, bi, bw
