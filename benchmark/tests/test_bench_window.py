"""The window's arithmetic on a recorded fake run: the metric readers and
the device summary."""

from __future__ import annotations

import pytest

import devtrace
import spec


def _isolate(start, wall, phases):
    return {
        "start": start,
        "end": start + wall,
        "wall_s": wall,
        "phases": [{"phase": n, "seconds": s} for n, s in phases],
    }


RUN = {
    "reads": 50_000,
    "setup_s": 31.5,
    "isolates": [
        _isolate(100.0, 12.0, [("load_fastq", 2.0), ("graph_cleaning", 3.0), ("initial_graph_build", 1.0), ("final_graph_build", 0.5)]),
        _isolate(112.0, 14.0, [("load_fastq", 3.0), ("graph_cleaning", 4.0), ("initial_graph_build", 1.5), ("final_graph_build", 0.5)]),
        _isolate(126.0, 10.0, [("load_fastq", 1.0), ("graph_cleaning", 2.0), ("initial_graph_build", 0.5), ("final_graph_build", 0.5)]),
    ],
}


def test_reads_per_s_is_all_reads_over_the_window():
    assert spec.reader("reads_per_s")(RUN) == pytest.approx(3 * 50_000 / 36.0)
    assert spec.reader("setup_s")(RUN) == 31.5


def test_outside_phases_is_wall_less_phases_on_average():
    # walls 12, 14, 10 less phases 6.5, 9, 4 -> 5.5, 5, 6
    assert spec.reader("outside_phases_s")(RUN) == pytest.approx(5.5)
    assert spec.reader("load_fastq_s")(RUN) == pytest.approx(2.0)
    assert spec.reader("graph_build_s")(RUN) == pytest.approx(1.5)
    assert spec.reader("polishing_s")(RUN) is None


def test_device_summary_and_rooflines():
    records = [
        ("void sw_dp_kernel<8>(...)", 100.5, 100.6),
        ("void sw_dp_kernel<8>(...)", 100.55, 100.65),  # overlaps the first
        ("void sw_traceback_kernel<256>(...)", 101.0, 101.01),
        ("Memcpy HtoD", 99.0, 100.2),  # starts before the window
    ]
    spans = [("allele_polishing", 100.4, 101.5), ("graph_cleaning", 102.0, 108.0)]
    s = devtrace.summarise(records, 100.0, 110.0, spans)
    assert s["busy_s"] == pytest.approx(0.2 + 0.15 + 0.01)
    assert s["window_s"] == pytest.approx(10.0)
    assert devtrace.kernel_seconds(s, "sw_dp_kernel") == pytest.approx(0.2)
    longest = s["idle_gaps"][0]
    assert longest[0] == "graph_cleaning" and longest[1] == pytest.approx(110.0 - 101.01)
    run = dict(RUN, trace=s, kernel_bounds_ms={"sw_dp": 100.0, "sw_traceback": 0.1})
    assert spec.reader("sw_dp_roofline")(run) == pytest.approx(50.0)
    assert spec.reader("sw_traceback_roofline")(run) == pytest.approx(1.0)
    assert spec.reader("device_idle_pct")(run) == pytest.approx(100 * (1 - 0.36 / 10))
    assert spec.reader("sw_dp_roofline")(RUN) is None


def test_launch_recorder_feeds_the_bounds():
    """The traced run's wrappers record each launch's inputs and the
    program's phases, and leave the program as it was."""
    import torch

    import bounds
    import run
    from amira_tpu_torch.ops import sw_batch
    from amira_tpu_torch.tracing import TIMER

    real = sw_batch.sw_dp
    spans, launches = [], {"sw_dp": [], "sw_traceback": []}
    W, Lq, B = 64, 32, 3
    g = torch.Generator().manual_seed(5)
    qs = torch.randint(0, 4, (B, Lq), dtype=torch.uint8, generator=g)
    rs = torch.randint(0, 4, (B, 3 * Lq + 3 * W), dtype=torch.uint8, generator=g)
    qlens = torch.tensor([32, 20, 0], dtype=torch.int32)
    dlos = torch.zeros(B, dtype=torch.int32)
    with run.recorded(spans, launches):
        packed, n_steps, *_ = sw_batch.sw_cigar(qs, rs, qlens, dlos, W)
        with TIMER.phase("polish"):
            pass
    assert sw_batch.sw_dp is real and "phase" not in vars(TIMER)
    assert [s[0] for s in spans] == ["polish"]
    got = run.kernel_bounds_ms(launches)
    assert got["sw_dp"] == bounds.dp_bound(qlens, W)[1][0]
    assert got["sw_traceback"] == bounds.tb_bound(packed, n_steps)[0]
