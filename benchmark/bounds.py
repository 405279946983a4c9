"""The least time the card could take for a launch of each SW kernel.

A frozen copy of `chip_smoke.py`'s `bound`, `dp_bound` and `tb_bound`, with
their constants:

- HBM_BYTES_PER_S: HBM3 at 3.35 TB/s, NVIDIA's H100 SXM data sheet.
- INT32_OPS_PER_S: 132 SMs x 64 int32 lanes x 1.98 GHz boost clock, from
  the Hopper white paper (a published figure, not measured here).
- SW_DP_OPS_PER_CELL = 39: int32 operations per live cell of sw_dp's
  recurrence, counted from the plain version (`sw_dp_reference`): the
  reference and match tests and the score 3; the max of the previous
  cell's five states with its nested >= predicates 4, and the code they
  pick 4; M = max(max(prev, 0) + score, 0) 1; M's predecessor code 3;
  M - OPEN and M - OPEN2 2; I and I2 2 each; D and D2 3 each; the masks
  outside the reference 5; the traceback byte's five flags 5; the row
  maximum at its first lane 2.
- SW_TB_OPS_PER_STEP = 20: int32 operations per step of sw_traceback's
  walk, counted from the loop of the first (one thread per job) kernel.

A launch's bound is the larger of its bytes over the HBM rate and its
operations over the int32 rate.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
SW_DP_OPS_PER_CELL = 39
SW_TB_OPS_PER_STEP = 20


def bound(bytes_, ops):
    """(ms, "bytes" or "operations", kind) for moving `bytes_` and issuing
    `ops` int32 operations."""
    b_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    o_ms = ops / INT32_OPS_PER_S * 1e3
    return (o_ms, "operations", "int32_issue") if o_ms >= b_ms else (b_ms, "bytes", "bytes")


def dp_bound(qlens, W):
    """(live cells, bound) of a sw_dp launch: each live query byte and
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
