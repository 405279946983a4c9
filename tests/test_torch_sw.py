"""The port's banded Smith-Waterman (`amira_tpu_torch.ops.sw_batch`) and
aligner (`amira_tpu_torch.ops.align`) against the JAX package.

The plain PyTorch versions (what the wrappers run on CPU tensors) are held
to the JAX package's XLA scan (`_batched_sw_cigar`) and to its Pallas kernel
run in interpret mode (`pallas_sw_cigar(..., interpret=True)`), on the
generator of tests/test_pallas_sw.py: noisy pairs at varied lengths,
strongly negative band diagonals, unrelated pairs and padded lanes. The
port's Aligner returns the same Alignments as the JAX Aligner under the XLA
engine, also on reads 10-20x longer than their genes, where each of its jobs
carries only the query rows its band can reach. On a CUDA device, the
kernels are held to the plain versions.

The CUDA DP cannot run here, so a NumPy model of how it computes (one warp
per job, lane l holding band lanes l*S .. l*S+S-1) is held to the plain
version: the deletion recurrence as strips joined by a warp scan, the row
maximum as one reduction over packed keys, and a whole row step that carries
the row-state chain into the next row's diagonal move.

The traceback walk is held to the JAX walk on random traceback bytes (long
gap runs, clamped lanes, walks that reach the step cap), and a NumPy model
of how the CUDA traceback walks (a run of steps at a time across the lanes
of a warp, tiles of rows by a window of lanes staged in shared memory, the
tiles below fetched ahead, re-staging when the walk leaves the window,
reads outside the band from device memory, copies that land only at their
wait, ops packed from a ring) is held to the plain version, at the kernel's
sizes and at small ones that miss often.

Tolerance: zero; scores, endpoints, packed ops and CIGARs are exact.
"""

import re

import jax
import numpy as np
import pytest
import torch

from amira_tpu.ops.align import Aligner as JaxAligner
from amira_tpu.ops.align import _batched_sw_cigar, _traceback_batch, _unpack_cigar
from amira_tpu.ops.align import _bucket as jax_bucket
from amira_tpu.ops.pallas_sw_batch import pallas_sw_cigar
from amira_tpu_torch.ops import sw_batch
from amira_tpu_torch.ops.align import (
    GAP_EXT,
    GAP_EXT2,
    GAP_OPEN,
    GAP_OPEN2,
    MATCH,
    MISMATCH,
    NEG,
)
from amira_tpu_torch.ops.align import Aligner as PortAligner
from amira_tpu_torch.ops.align import _bucket as port_bucket
from chip_smoke import random_band

NAMES = ("packed", "n_steps", "q0", "r0", "best", "bi", "bw")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain SW versions run many small torch ops: one intra-op thread
    is as fast here, and keeps parallel test workers off each other's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _mutated_pair(rng, n, sub=0.05, del_p=0.03, ins_p=0.03):
    q = rng.randint(0, 4, size=n).astype(np.uint8)
    r = []
    for ch in q:
        x = rng.rand()
        if x < sub:
            r.append(rng.randint(0, 4))
        elif x < sub + del_p:
            continue
        elif x < sub + del_p + ins_p:
            r.extend([ch, rng.randint(0, 4)])
        else:
            r.append(ch)
    return q, np.array(r, dtype=np.uint8)


def _batch(W, lq, B, seed=7, n_padded=0):
    rng = np.random.RandomState(seed)
    P = W + lq
    rlen = jax_bucket(2 * lq + 2 * W + 2 * lq)
    qs, rs, qlens, dlos = [], [], [], []
    for b in range(B):
        n = rng.randint(8, lq)
        if b % 5 == 4:  # unrelated pair: likely unmapped
            q = rng.randint(0, 4, size=n).astype(np.uint8)
            r = rng.randint(0, 4, size=n).astype(np.uint8)
        else:
            q, r = _mutated_pair(rng, n)
        qpad = np.full(lq, 4, np.uint8)
        qpad[: len(q)] = q
        rpad = np.full(rlen, 4, np.uint8)
        rpad[P : P + len(r)] = r
        qs.append(qpad)
        rs.append(rpad)
        qlens.append(len(q))
        dlos.append(int(rng.randint(-(lq - 1), max(len(r) - 1, 1))))
    for _ in range(n_padded):  # padded lanes, as the JAX aligner adds
        qs.append(np.full(lq, 4, np.uint8))
        rs.append(np.full(rlen, 4, np.uint8))
        qlens.append(0)
        dlos.append(0)
    return (
        np.stack(qs), np.stack(rs), np.asarray(qlens, np.int32),
        np.asarray(dlos, np.int32),
    )


def _torch(arrays, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrays]


def _edge_batch(W, lq, B, seed=5):
    """_batch with the kernel's edge cases planted: padded jobs (qlen 0),
    qlen 1 and qlen < W/32, and strongly negative band diagonals."""
    qs, rs, qlens, dlos = _batch(W, lq, B - 3, seed=seed, n_padded=3)
    qlens[0], qlens[1], qlens[2] = 1, W // 32 - 1, 3
    dlos[3], dlos[4] = -(lq - 1), -(lq - W // 2)
    return qs, rs, qlens, dlos


# ------------------------------------------- NumPy model of the CUDA DP


def _strip_deletions(Mc, gap_open, gap_ext):
    """The kernel's deletion recurrence on rows of masked M (R, W). Each
    lane l holds band lanes l*S .. l*S+S-1: its running max of M + s*ext
    gives each element's candidate from earlier elements of the strip (t),
    and the strip maximum of M + w*ext goes into a 5-step shuffle-up max
    scan over the 32 lanes (lanes below the offset keep their own value),
    whose exclusive result is the carry from earlier lanes. Then
    D = max(carry - open - (w-1)*ext, t), clamped to NEG. Returns
    (D, extend flags D[w-1] - ext >= M[w-1] - open)."""
    R, W = Mc.shape
    S = W // 32
    M = Mc.reshape(R, 32, S).astype(np.int64)
    lane, s_idx = np.arange(32), np.arange(S)
    pre = np.maximum.accumulate(M + s_idx * gap_ext, axis=2)
    t = np.full_like(M, NEG)
    t[:, :, 1:] = np.maximum(pre[:, :, :-1] - gap_open - (s_idx[1:] - 1) * gap_ext, NEG)
    a = pre[:, :, -1] + lane * S * gap_ext
    off = 1
    while off < 32:
        a = np.maximum(a, np.concatenate([a[:, :off], a[:, :-off]], axis=1))
        off *= 2
    ea = np.concatenate([np.full((R, 1), NEG), a[:, :-1]], axis=1)
    x0 = ea - gap_open - (lane * S - 1) * gap_ext
    D = np.maximum(x0[:, :, None] - s_idx * gap_ext, t)
    ext = np.empty(M.shape, bool)
    ext[:, :, 1:] = D[:, :, :-1] - gap_ext >= M[:, :, :-1] - gap_open
    # element 0 compares against lane l-1's element S-1 (NEG left of lane 0)
    d_left = np.concatenate([np.full((R, 1), NEG), D[:, :-1, S - 1]], axis=1)
    m_left = np.concatenate([np.full((R, 1), NEG), M[:, :-1, S - 1]], axis=1)
    ext[:, :, 0] = d_left - gap_ext >= m_left - gap_open
    return D.reshape(R, W), ext.reshape(R, W)


def _val_shift(W):
    """Bit position of the score in the kernel's cell codes."""
    return W.bit_length() - 1 + 3


def _encode(x, prio, W):
    """The kernel's code of one cell component: max(x, 0) << (log2 W + 3) |
    priority (M 6, I 5, D 4, I2 3, D2 2)."""
    return (np.maximum(np.asarray(x, np.int64), 0) << _val_shift(W)) | prio


def _reduce_keys(keys):
    """The kernel's row maximum over cell keys (R, W) (code plus lane bits
    (W-1-w) << 3): the max over each lane's strip, then over the warp,
    decoded to (score, lane, state)."""
    R, W = keys.shape
    assert int(keys.max()) < 1 << 32
    rk = keys.reshape(R, 32, W // 32).max(axis=2).max(axis=1)
    return rk >> _val_shift(W), W - 1 - ((rk >> 3) & (W - 1)), 6 - (rk & 7)


def _lane_bits(W):
    return (W - 1 - np.arange(W, dtype=np.int64)) << 3


def _kernel_model(qs, rs, qlens, dlos, W):
    """sw_dp as the kernel computes it, job by job. The encoded row state of
    row i (score and state of the first component, in M, I, D, I2, D2 order,
    holding the cell's maximum) is the diagonal input of row i+1; the
    insertions read M - OPEN and I - EXT (and the I2 pair) carried from lane
    w+1 of the previous row; deletions and the row maximum as above. Rows
    at or past qlen stay 0."""
    B, Lq = qs.shape
    Lr = rs.shape[1]
    w = np.arange(W)
    pos = 1 << _val_shift(W)
    tb = np.zeros((B, Lq, W), np.uint8)
    out = np.zeros((4, B), np.int64)
    out[1:3] = -1

    def up(x, edge):  # band lane w+1 of the previous row
        return np.append(x[1:], edge)

    for b in range(B):
        e = np.zeros(W, np.int64)
        mo, mo2 = np.full(W, -GAP_OPEN), np.full(W, -GAP_OPEN2)
        ie, i2e = np.full(W, NEG - GAP_EXT), np.full(W, NEG - GAP_EXT2)
        for i in range(min(max(int(qlens[b]), 0), Lq)):
            ri = int(dlos[b]) + W + Lq + i + w
            rc = np.where((ri >= 0) & (ri < Lr), rs[b, np.clip(ri, 0, Lr - 1)], 4)
            in_ref, eq = rc != 4, rc == qs[b, i]
            # max(prev_best, 0) + score
            mdiag = (e >> _val_shift(W)) + np.where(eq, MATCH, MISMATCH)
            m_bits = np.where((e >= pos) & (mdiag > 0), ~e & 7, 0)
            Mc = np.where(in_ref, np.maximum(mdiag, 0), NEG)
            mou, mo2u = up(mo, NEG - GAP_OPEN), up(mo2, NEG - GAP_OPEN2)
            ieu, i2eu = up(ie, NEG - GAP_EXT), up(i2e, NEG - GAP_EXT2)
            Iv, I2v = np.maximum(ieu, mou), np.maximum(i2eu, mo2u)
            D, d_ext = _strip_deletions(Mc[None], GAP_OPEN, GAP_EXT)
            D2, d2_ext = _strip_deletions(Mc[None], GAP_OPEN2, GAP_EXT2)
            tb[b, i] = (
                m_bits | (ieu >= mou) << 3 | d_ext[0] << 4 | (i2eu >= mo2u) << 5
                | d2_ext[0] << 6 | eq << 7
            )
            codes = [_encode(x, p, W) for x, p in ((Mc, 6), (Iv, 5), (D[0], 4), (I2v, 3), (D2[0], 2))]
            e = np.where(in_ref, np.max(codes, axis=0) + _lane_bits(W), 0)
            rv, rw, st = (x[0] for x in _reduce_keys(e[None]))
            if rv > out[0, b]:
                out[:, b] = rv, i, rw, st
            mo, mo2 = Mc - GAP_OPEN, Mc - GAP_OPEN2
            ie = np.where(in_ref, Iv - GAP_EXT, NEG - GAP_EXT)
            i2e = np.where(in_ref, I2v - GAP_EXT2, NEG - GAP_EXT2)
    return tb, out


def _masked_m_rows(rng, R, W):
    """Rows of masked M: scores 0..60 with NEG (out-of-reference) lanes in
    runs at either edge and scattered, some rows all NEG or all 0."""
    M = rng.randint(0, 61, size=(R, W)).astype(np.int32)
    M[rng.rand(R, W) < 0.1] = NEG
    for r in range(R):
        cut = rng.randint(0, W + 1)
        if r % 3 == 0:
            M[r, :cut] = NEG
        elif r % 3 == 1:
            M[r, cut:] = NEG
    M[0], M[1] = NEG, 0
    return M


def _cummax_deletions(M_cur, gap_open, gap_ext):
    """One row's deletion recurrence as sw_dp_reference computes it, on
    rows of masked M (R, W): the exclusive prefix max of M + w*ext through
    torch.cummax, D = max(that - open - (w-1)*ext, NEG), and the extend
    flags D[w-1] - ext >= M[w-1] - open (NEG left of lane 0)."""
    w_idx = torch.arange(M_cur.shape[1], dtype=torch.int32)[None, :]
    negcol = torch.full_like(M_cur[:, :1], NEG)

    def shift_left(x):  # lane w-1 -> w
        return torch.cat([negcol, x[:, :-1]], dim=1)

    A_shift = shift_left(torch.cummax(M_cur + w_idx * gap_ext, dim=1).values)
    D_un = torch.maximum(A_shift - gap_open - (w_idx - 1) * gap_ext, negcol)
    ext = (shift_left(D_un) - gap_ext) >= (shift_left(M_cur) - gap_open)
    return D_un, ext


@pytest.mark.parametrize("W", [64, 128, 256, 512])
def test_strip_scan_deletions_match_cummax(W):
    M = _masked_m_rows(np.random.RandomState(W), 300, W)
    for gap_open, gap_ext in ((GAP_OPEN, GAP_EXT), (GAP_OPEN2, GAP_EXT2)):
        ref_d, ref_ext = _cummax_deletions(torch.from_numpy(M), gap_open, gap_ext)
        got_d, got_ext = _strip_deletions(M, gap_open, gap_ext)
        np.testing.assert_array_equal(got_d, ref_d.numpy())
        np.testing.assert_array_equal(got_ext, ref_ext.numpy())
        # the same values as the sequential recurrence on the unmasked D
        seq = np.maximum(np.maximum(got_d[:, :-1] - gap_ext, M[:, :-1] - gap_open), NEG)
        np.testing.assert_array_equal(got_d[:, 1:], seq)
        assert (ref_d.numpy() == NEG).any() and (ref_d.numpy() > NEG).any()


@pytest.mark.parametrize("W", [64, 128, 256, 512])
def test_packed_key_row_max_matches_first_lane(W):
    rng = np.random.RandomState(W + 1)
    R = 400
    vals = rng.randint(-8, 12, size=(R, W)).astype(np.int32)
    vals[rng.rand(R, W) < 0.1] = NEG
    for r in range(0, R, 2):  # plant ties of the row maximum
        top = int(vals[r].max()) + rng.randint(0, 3)
        vals[r, rng.choice(W, size=rng.randint(2, 6), replace=False)] = top
    vals[-1] = NEG
    vals[-2] = 0
    states = rng.randint(0, 5, size=(R, W))
    rv, rw, st = _reduce_keys(_encode(vals, 6 - states, W) + _lane_bits(W))
    ref_v, ref_w = torch.from_numpy(vals).max(dim=1)
    ref_v, ref_w = ref_v.numpy(), ref_w.numpy()
    pos = ref_v > 0
    assert pos.sum() > R // 2 and (~pos).any()
    np.testing.assert_array_equal(rv[pos], ref_v[pos])
    np.testing.assert_array_equal(rw[pos], ref_w[pos])
    np.testing.assert_array_equal(st[pos], states[pos, ref_w[pos]])
    # a row whose maximum is <= 0 decodes to <= 0 and can never raise the best
    assert (rv[~pos] <= 0).all()


@pytest.mark.parametrize(
    "W,lq,B", [(64, 128, 24), (128, 256, 9), (256, 192, 37), (512, 192, 9)]
)
def test_kernel_model_matches_plain_version(W, lq, B):
    arrays = _edge_batch(W, lq, B)
    tb, out = _kernel_model(*arrays, W)
    r_tb, *r_out = sw_batch.sw_dp_reference(*_torch(arrays), W)
    np.testing.assert_array_equal(out, np.stack([t.numpy() for t in r_out]))
    live = np.arange(lq)[None, :] < arrays[2][:, None]
    np.testing.assert_array_equal(tb[live], r_tb.numpy()[live])
    assert (out[0] > 0).sum() >= B // 2


@pytest.mark.parametrize(
    "W,lq,B,edges",
    [
        pytest.param(64, 128, 24, False, id="64-128-24"),
        pytest.param(128, 256, 9, False, id="128-256-9"),
        # the main path's band width, with the DP's edge cases planted
        pytest.param(256, 192, 16, True, id="256-192-16-edges"),
        # the assembly's polishing band (S = 16 lanes a thread in the kernel)
        pytest.param(512, 192, 9, True, id="512-192-9-edges"),
    ],
)
def test_plain_version_matches_xla_and_pallas(W, lq, B, edges):
    arrays = _edge_batch(W, lq, B) if edges else _batch(W, lq, B, n_padded=3)
    xla = [np.asarray(x) for x in _batched_sw_cigar(*arrays, W)]
    pls = [np.asarray(x) for x in pallas_sw_cigar(*arrays, W, interpret=True)]
    got = [t.numpy() for t in sw_batch.sw_cigar_reference(*_torch(arrays), W)]
    for i, name in enumerate(NAMES):
        # the packed layout equals the XLA walk's byte for byte
        np.testing.assert_array_equal(got[i], xla[i], err_msg=name)
        if name != "packed":
            np.testing.assert_array_equal(got[i], pls[i], err_msg=name)
    n_checked = 0
    for b in range(len(arrays[0])):
        if xla[5][b] < 0 or xla[4][b] <= 0:
            continue
        cig = _unpack_cigar(got[0][b], int(got[1][b]))
        assert cig == _unpack_cigar(xla[0][b], int(xla[1][b])), b
        assert cig == _unpack_cigar(pls[0][b], int(pls[1][b])), b
        n_checked += 1
    assert n_checked >= B // 2


# --------------------------------------- the traceback walk, tile by tile


def _kernel_tile():
    """The CUDA traceback's tile constants (query rows, band lanes, tiles
    per warp, ops staged), read from csrc/sw_batch.cu so that the model
    below runs as the kernel does."""
    with open(sw_batch._SRC) as f:
        src = f.read()
    return tuple(
        int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
        for name in ("kTbRows", "kTbWin", "kTbTiles", "kTbOps")
    )


def _pack_block(ops, blk, n):
    """The kernel's packing of block `blk` (256 steps) of the ops staged in
    the ring `ops` (bytes, garbage past the walk's end): each 4 bytes read
    as one little-endian word x, x & 0x03030303 folded to a byte by
    x | x >> 6 | x >> 12 | x >> 18, four such bytes to a word, and the
    word's bits for steps >= n cleared."""
    ring = len(ops)
    staged = np.array([ops[(blk * 256 + t) % ring] for t in range(256)], np.uint8)
    x = staged.view("<u4").astype(np.int64) & 0x03030303
    folded = (x | x >> 6 | x >> 12 | x >> 18) & 0xFF
    words = (folded.reshape(16, 4) << np.arange(0, 32, 8)).sum(axis=1)
    first = blk * 256 + 16 * np.arange(16)  # each word's first step
    keep = np.where(first + 16 <= n, 0xFFFFFFFF, (1 << (2 * np.clip(n - first, 0, 16))) - 1)
    return (words & keep).astype("<u4").view(np.uint8)


def _tiled_walk_model(tb, best, bi, bw, bs, dlos, W, rows, win, n_tiles, n_ops, lanes=32, seed=0):
    """sw_traceback as the kernel walks, job by job, on numpy arrays.

    A warp of `lanes` lanes walks a run at a time: lane j reads the cell of
    step n + j if the walk keeps its state until then, from the tile it
    reads (`rows` query rows by `win` band lanes); the run ends at the first
    cell outside the tile, not taken, or the first that leaves the state,
    taken. When the walk's own cell is outside its tile, it enters the tile
    below (the oldest of the n_tiles - 1 in flight) or, if it left the
    window, stages n_tiles tiles anew at (i, w) (a re-stage, after the
    first); a cell outside the band is one step on the clamped cell read
    from the band itself. Copies land only when the kernel waits for them;
    tiles hold garbage until then. Ops go into a ring of n_ops bytes, packed
    256 at a time.

    Returns (packed, n_steps, q0, r0) and counts of stages, re-stages, tiles
    entered from above, runs and steps outside the band."""
    B, Lq, _ = tb.shape
    cap = sw_batch.tb_steps(Lq, W)
    win = min(win, W)
    rng = np.random.RandomState(seed)
    lane = np.arange(lanes)

    def window(w):
        return min(max((w - win // 2 + 8) & ~15, 0), W - win)

    packed = np.zeros((B, cap // 4), np.uint8)
    out = np.zeros((3, B), np.int64)
    counts = dict(stages=0, restages=0, entered=0, runs=0, outside=0)
    for b in range(B):
        i, w, state, n = int(bi[b]), int(bw[b]), int(bs[b]), 0
        ops = rng.randint(0, 256, size=n_ops)  # garbage until written
        if best[b] > 0 and i >= 0 and cap > 0:
            tiles = rng.randint(0, 256, size=(n_tiles, rows, win))
            flight = []  # copy groups in flight, oldest first

            def stage(slot, first, lane0):
                assert lane0 % 16 == 0 and 0 <= lane0 <= W - win  # 16-byte copies
                flight.append((slot, first, lane0))

            def wait(keep):
                while len(flight) > keep:
                    slot, first, lane0 = flight.pop(0)
                    for r in range(max(first, 0), first + rows):
                        tiles[slot, r - first] = tb[b, r, lane0 : lane0 + win]

            cur, base, c0, staged = 0, None, 0, False
            while True:
                is_m, is_i = state == 0, state in (1, 3)
                di = 1 if is_m or is_i else 0
                dw = 1 if is_i else -1 if state in (2, 4) else 0
                ebit = 7 if is_m else {1: 3, 2: 4, 3: 5}.get(state, 6)
                ij, wj = i - lane * di, w + lane * dw
                inside = (ij >= 0) & (n + lane < cap)
                if base is not None:
                    inside &= (ij - base >= 0) & (ij - base < rows) & (wj - c0 >= 0) & (wj - c0 < win)
                else:
                    inside &= False
                byte = np.where(inside, tiles[cur % n_tiles, np.clip(ij - (base or 0), 0, rows - 1), np.clip(wj - c0, 0, win - 1)], 0)
                pred, e = byte & 7, (byte >> ebit) & 1
                stays = ((pred == 1) | (pred >= 6)) if is_m else e == 1
                stops = ~inside | (inside & ~stays)
                first = int(np.argmax(stops)) if stops.any() else lanes
                left = first < lanes and bool(inside[first])
                k = first + left
                if k > 0:
                    counts["runs"] += 1
                    op = np.where(byte >> 7, sw_batch.OP_EQ, sw_batch.OP_X) if is_m else np.full(lanes, sw_batch.OP_I if is_i else sw_batch.OP_D)
                    for j in range(k):
                        ops[(n + j) % n_ops] = op[j]
                    nstate, done = state, False
                    if left:
                        lp = int(pred[first])
                        nstate = (lp - 1 if 1 <= lp <= 5 else 0) if is_m else 0
                        done = is_m and lp == 0
                    steps = k
                elif i < Lq and 0 <= w < W:
                    if staged and 0 <= i - (base - rows) < rows and 0 <= w - c0 < win:
                        wait(n_tiles - 2)
                        cur, base = cur + 1, base - rows
                        counts["entered"] += 1
                        stage((cur - 1) % n_tiles, base - (n_tiles - 1) * rows, c0)
                    else:
                        counts["restages"] += staged
                        counts["stages"] += 1
                        staged = True
                        wait(0)
                        cur, base, c0 = 0, i - rows + 1, window(w)
                        for slot in range(n_tiles):
                            stage(slot, base - slot * rows, c0)
                        wait(n_tiles - 1)
                    continue
                else:
                    counts["outside"] += 1
                    gb = int(tb[b, min(i, Lq - 1), min(max(w, 0), W - 1)])
                    gp, ge = gb & 7, (gb >> ebit) & 1
                    ops[n % n_ops] = (sw_batch.OP_EQ if gb >> 7 else sw_batch.OP_X) if is_m else sw_batch.OP_I if is_i else sw_batch.OP_D
                    nstate = (gp - 1 if 1 <= gp <= 5 else 0) if is_m else (state if ge else 0)
                    done = is_m and gp == 0
                    steps = 1
                n0 = n
                i, w, n, state = i - steps * di, w + steps * dw, n + steps, nstate
                if n0 // 256 != n // 256:
                    blk = n0 // 256
                    packed[b, blk * 64 : blk * 64 + 64] = _pack_block(ops, blk, n)
                if done or i < 0 or n >= cap:
                    break
        if n % 256:
            blk = n // 256
            packed[b, blk * 64 : blk * 64 + 64] = _pack_block(ops, blk, n)
        out[:, b] = n, i + 1, i + 1 + int(dlos[b]) + w
    return (packed, *out), counts


def _dp_band(W, lq, B):
    """A DP-made band with its walk starts: sw_dp_reference on _edge_batch,
    as numpy arrays (tb, best, bi, bw, bs, dlos)."""
    arrays = _edge_batch(W, lq, B)
    tb, best, bi, bw, bs = (t.numpy() for t in sw_batch.sw_dp_reference(*_torch(arrays), W))
    return tb, best, bi, bw, bs, arrays[3]


@pytest.mark.parametrize("W,lq,B", [(64, 96, 40), (256, 192, 24), (512, 96, 16)])
def test_plain_walk_matches_xla_on_random_bytes(W, lq, B):
    tb, best, bi, bw, bs, dlos = random_band(W, lq, B, seed=W + lq)
    # the JAX walk reads the scan-major (Lq, B, W) band
    walk = jax.jit(_traceback_batch, static_argnums=(1, 2, 7))
    packed, n, q0, fw = (np.asarray(x) for x in walk(tb.transpose(1, 0, 2), B, lq, best, bi, bw, bs, W))
    got = [t.numpy() for t in sw_batch.sw_traceback_reference(*_torch((tb, best, bi, bw, bs, dlos)), W)]
    for name, g, x in zip(("packed", "n_steps", "q0", "r0"), got, (packed, n, q0, q0 + dlos + fw)):
        np.testing.assert_array_equal(g, x, err_msg=name)
    # long walks: some reach the step cap, some end early, some never start
    cap = sw_batch.tb_steps(lq, W)
    assert (n == cap).any() and ((n > 0) & (n < cap)).any() and (n == 0).any()


@pytest.mark.parametrize("tile", ["small", "kernel"])
@pytest.mark.parametrize("W", [64, 128, 256, 512])
def test_tiled_walk_model_matches_plain_version(W, tile):
    # the small tile (4 rows, one 16-byte chunk of lanes, one tile in flight,
    # runs of at most 8 steps) misses often: the walk leaves its window and
    # crosses tiles mid-run
    if tile == "small":
        shape = dict(rows=4, win=16, n_tiles=2, n_ops=512, lanes=8)
    else:
        shape = dict(zip(("rows", "win", "n_tiles", "n_ops"), _kernel_tile()))
    counts = {}
    for name, band in (("random", random_band(W, 96, 24, seed=W + 1)), ("dp", _dp_band(W, 640, 24))):
        got, counts[name] = _tiled_walk_model(*band, W, **shape)
        ref = sw_batch.sw_traceback_reference(*_torch(band), W)
        for out, g, r in zip(("packed", "n_steps", "q0", "r0"), got, ref):
            np.testing.assert_array_equal(g, r.numpy(), err_msg=f"{name} {out}")
        assert counts[name]["stages"] > 0, name
    # DP-made walks cross tiles; random ones leave the window and the band
    # (their reads there are clamped)
    assert counts["dp"]["entered"] > 0 and counts["random"]["outside"] > 0
    if tile == "small":
        assert counts["random"]["restages"] > 0
    if tile == "kernel":  # DP-made walks take several steps per run
        assert counts["dp"]["runs"] * 4 < got[1].sum()

def test_dp_and_traceback_split_matches_fused():
    W, lq, B = 64, 128, 16
    arrays = _torch(_batch(W, lq, B, seed=11))
    tb, best, bi, bw, bs = sw_batch.sw_dp(*arrays, W)
    assert tb.shape == (B, lq, W) and tb.dtype == torch.uint8
    packed, n_steps, q0, r0 = sw_batch.sw_traceback(tb, best, bi, bw, bs, arrays[3], W)
    fused = sw_batch.sw_cigar(*arrays, W)
    for a, b in zip((packed, n_steps, q0, r0, best, bi, bw), fused):
        assert torch.equal(a, b)
    assert packed.shape == (B, sw_batch.tb_steps(lq, W) // 4)


def test_fine_buckets_match_jax_cpu_ladder():
    for n in list(range(1, 300)) + [1000, 1100, 2047, 2049, 4000, 5000]:
        assert port_bucket(n) == jax_bucket(n), n


def _reads_and_ref(seed=3, n_reads=12):
    rng = np.random.RandomState(seed)
    bases = np.array(list("ACGT"))
    ref = "".join(rng.choice(bases, size=700))
    reads = {}
    for i in range(n_reads):
        s = rng.randint(0, 200)
        e = rng.randint(s + 300, min(s + 650, 700))
        seq = list(ref[s:e])
        for j in range(0, len(seq), 17):
            seq[j] = str(rng.choice(bases))
        if i % 4 == 3:  # a structural gap wider than the band
            seq = seq[:120] + seq[220:]
        seq = "".join(seq)
        if i % 3 == 2:
            seq = seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        reads[f"r{i}"] = seq
    return ref, reads


def _assert_same_alignments(got, ref):
    assert got.keys() == ref.keys()
    for rid in got:
        assert got[rid].keys() == ref[rid].keys()
        for name in got[rid]:
            sg, ag = got[rid][name]
            sr, ar = ref[rid][name]
            assert sg == sr
            assert vars(ag) == vars(ar)  # every field, CIGAR included


def test_aligner_map_reads_and_diagonals_match_jax(monkeypatch):
    monkeypatch.setenv("AMIRA_TPU_SW_ENGINE", "xla")
    ref_seq, reads = _reads_and_ref()
    refs = {"ref": ref_seq, "alt": ref_seq[100:600]}
    jax_al = JaxAligner(refs, band_width=64)
    port_al = PortAligner(refs, band_width=64, device="cpu")
    jax_hits = jax_al.map_reads(dict(reads))
    port_hits = port_al.map_reads(dict(reads))
    _assert_same_alignments(port_hits, jax_hits)
    assert sum(len(h) for h in port_hits.values()) >= len(reads)
    # the polish loop's route: bands placed from the previous alignment
    targets = {
        rid: ("ref", h["ref"][0], h["ref"][1].r_start - h["ref"][1].q_start + 5)
        for rid, h in jax_hits.items()
        if "ref" in h
    }
    _assert_same_alignments(
        port_al.map_with_diagonals(dict(reads), targets),
        jax_al.map_with_diagonals(dict(reads), targets),
    )


def _rc(seq):
    return seq.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


def _long_read_case(case):
    """(references, reads, band targets) of one shape of reads 10-20x longer
    than the genes: the band reaches a short window of each job's rows.
    `targets` is None where the polish loop's targets (from the JAX hits)
    are used; else explicit band placements for `map_with_diagonals`."""
    rng = np.random.RandomState(sum(map(ord, case)))
    bases = np.array(list("ACGT"))

    def rand(n):
        return "".join(rng.choice(bases, size=n))

    def noisy(seq):
        s = list(seq)
        for j in range(5, len(s), 23):
            s[j] = str(rng.choice(bases))
        return "".join(s)

    refs = {"geneA": rand(200), "geneB": rand(160)}
    a, b = refs["geneA"], refs["geneB"]
    targets = None
    if case in ("middle", "middle_minus"):
        reads = {"r0": rand(1400) + noisy(a) + rand(1500), "r1": rand(2500) + noisy(b) + rand(900)}
    elif case in ("start", "start_minus"):  # the gene runs off row 0
        reads = {"r0": noisy(a[70:]) + rand(2900), "r1": rand(20) + noisy(b) + rand(3300)}
    elif case in ("end", "end_minus"):  # the gene runs off the last row
        reads = {"r0": rand(2900) + noisy(a[:150]), "r1": rand(3700) + noisy(b) + rand(15)}
    elif case == "two_copies":  # two chains of one read, two windows
        reads = {"r0": rand(300) + noisy(a) + rand(1500) + noisy(a) + rand(900) + noisy(b)}
    elif case == "strand_tie":
        # r1 holds geneA at its start and its reverse complement inside: the
        # two strands score alike, and the + strand's window (it runs off
        # row 0) falls in a smaller bucket than the - strand's, which r0's
        # job opens first; the JAX package keeps the + strand
        reads = {"r0": rand(1400) + noisy(a) + rand(1500), "r1": a + rand(1500) + _rc(a) + rand(1400)}
    elif case == "with_n":
        read = list(rand(1800) + noisy(a) + rand(1200))
        for j in (3, 900, 1830, 1901, 1950, 2600):
            read[j] = "N"
        reads = {"r0": "".join(read)}
    elif case == "clamps":
        # 3,072 rows, a bucket of its own: the low clamp (1 - 3072) leaves
        # the last 64 rows, which hold geneA's head; past the high clamp the
        # band starts at geneB's last base and keeps row 0 alone
        reads = {"low": rand(3012) + a[:60], "high": b[-1] + rand(2999)}
        targets = {"low": ("geneA", "+", -10**6), "high": ("geneB", "+", 10**6)}
    elif case == "empty_window":
        # 2,100 rows in the 3,072 bucket: at the low clamp the band reaches
        # the reference only past the read's end
        reads = {"r0": rand(2100)}
        targets = {"r0": ("geneA", "+", -10**6)}
    if case.endswith("_minus"):
        reads = {rid: _rc(seq) for rid, seq in reads.items()}
    return refs, reads, targets


@pytest.mark.parametrize(
    "case",
    ["middle", "middle_minus", "start", "start_minus", "end", "end_minus",
     "two_copies", "strand_tie", "with_n", "clamps", "empty_window"],
)
def test_aligner_on_long_reads_matches_jax(case, monkeypatch):
    """Reads 10-20x longer than their genes, where each job carries only the
    query rows its band reaches: every Alignment of map_reads and of
    map_with_diagonals equals the JAX package's, which runs every row."""
    monkeypatch.setenv("AMIRA_TPU_SW_ENGINE", "xla")
    refs, reads, targets = _long_read_case(case)
    W = 64
    jax_al = JaxAligner(refs, band_width=W)
    port_al = PortAligner(refs, band_width=W, device="cpu")
    sent = []
    real = sw_batch.sw_cigar

    def sw_cigar(qs, rs, qlens, dlos, W):
        sent.extend(qlens.tolist())
        return real(qs, rs, qlens, dlos, W)

    monkeypatch.setattr(sw_batch, "sw_cigar", sw_cigar)
    if targets is None:
        jax_hits = jax_al.map_reads(dict(reads))
        _assert_same_alignments(port_al.map_reads(dict(reads)), jax_hits)
        assert sum(len(h) for h in jax_hits.values()) >= len(reads)
        targets = {
            rid: (name, strand, aln.r_start - aln.q_start + 5)
            for rid, h in jax_hits.items()
            for name, (strand, aln) in h.items()
        }
    got = port_al.map_with_diagonals(dict(reads), targets)
    _assert_same_alignments(got, jax_al.map_with_diagonals(dict(reads), targets))
    # no job sent more rows than its band can reach
    assert all(0 < n <= max(map(len, refs.values())) + W - 1 for n in sent)
    if case == "strand_tie":
        assert got["r1"]["geneA"][0] == "+"
    if case == "clamps":
        assert got.keys() == {"low", "high"} and sorted(sent) == [1, 64]
    if case == "empty_window":
        assert got == {} and sent == []


@pytest.mark.cuda
@pytest.mark.parametrize(
    "W,lq,B,band",
    [
        (64, 128, 24, "dp"),
        (128, 256, 9, "dp"),
        (256, 192, 37, "dp"),
        (256, 1024, 96, "dp"),
        (256, 512, 300, "random"),
        (512, 640, 37, "dp"),
        (512, 256, 48, "random"),
    ],
)
def test_kernels_match_plain_version_on_gpu(W, lq, B, band, cuda_device):
    if band == "random":  # random traceback bytes: the walk alone
        args = _torch(random_band(W, lq, B, seed=B), cuda_device)
        got = sw_batch.sw_traceback(*args, W)
        ref = sw_batch.sw_traceback_reference(*args, W)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
        return
    arrays = _torch(_edge_batch(W, lq, B), cuda_device)
    tb, best, bi, bw, bs = sw_batch.sw_dp(*arrays, W)
    ref_dp = sw_batch.sw_dp_reference(*arrays, W)
    for a, b in zip((best, bi, bw, bs), ref_dp[1:]):
        assert torch.equal(a, b)
    qlens = arrays[2].tolist()
    for j, n in enumerate(qlens):  # rows past qlen are unspecified
        assert torch.equal(tb[j, :n], ref_dp[0][j, :n])
    got = sw_batch.sw_traceback(tb, best, bi, bw, bs, arrays[3], W)
    ref = sw_batch.sw_traceback_reference(ref_dp[0], *ref_dp[1:], arrays[3], W)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
