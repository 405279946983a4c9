"""The frozen bound arithmetic equals chip_smoke.py's."""

from __future__ import annotations

import torch

import bounds
import chip_smoke


def test_constants_equal():
    for name in ("HBM_BYTES_PER_S", "INT32_OPS_PER_S", "SW_DP_OPS_PER_CELL", "SW_TB_OPS_PER_STEP"):
        assert getattr(bounds, name) == getattr(chip_smoke, name)


def test_bounds_equal_on_fixed_inputs():
    g = torch.Generator().manual_seed(3)
    for B, W in ((980, 256), (6, 512), (48, 64), (1, 128)):
        qlens = torch.randint(0, 1024, (B,), generator=g, dtype=torch.int32)
        qlens[0] = 0
        assert bounds.dp_bound(qlens, W) == chip_smoke.dp_bound(qlens, W)
        packed = torch.zeros((B, 700), dtype=torch.uint8)
        n_steps = torch.randint(0, 2800, (B,), generator=g, dtype=torch.int32)
        assert bounds.tb_bound(packed, n_steps) == chip_smoke.tb_bound(packed, n_steps)
    # the main path's largest polishing launch is bound by int32 issue
    ms, which, _kind = bounds.dp_bound(torch.full((980,), 1024, dtype=torch.int32), 256)[1]
    assert which == "operations" and 0.5 < ms < 0.6
