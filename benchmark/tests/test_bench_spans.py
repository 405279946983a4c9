"""The span readers (`spans.py` and the metrics that use it) on a fake run
whose isolates' output directories hold hand-written phase_timings.json
files, one isolate without one, and `sw_dp_gcells_per_s` against a fake
device summary."""

from __future__ import annotations

import json

import pytest

import devtrace
import spec

S = 1_000_000_000  # nanoseconds a second


def _span(name, start, end, spans=(), **counters):
    entry = {"span": name, "start_ns": int(start * S), "end_ns": int(end * S), "seconds": end - start}
    if spans:
        entry["spans"] = list(spans)
    if counters:
        entry["counters"] = counters
    return entry


def _phase(name, start, end, spans=(), **meta):
    entry = {"phase": name, **meta, "start_ns": int(start * S), "end_ns": int(end * S),
             "seconds": round(end - start, 3)}
    if spans:
        entry["spans"] = list(spans)
    return entry


def _isolate(tmp_path, name, phases):
    out = tmp_path / name
    out.mkdir()
    if phases is not None:
        (out / "phase_timings.json").write_text(json.dumps(phases))
    return {"out": str(out), "phases": [], "wall_s": 1.0}


def _kernels(start, end, cells):
    return _span("align.kernels", start, end, launches=1, jobs=4, live_cells=cells, tb_steps=10)


@pytest.fixture
def run(tmp_path):
    first = [
        _phase("ingest_gene_calls", 0.0, 10.0, [
            _span("align.seed", 0.0, 4.0),
            _span("align.pack", 4.0, 4.5), _kernels(4.5, 6.0, 1_000), _span("align.unpack", 6.0, 6.5),
            _span("align.pack", 6.5, 7.0), _kernels(7.0, 8.0, 2_000), _span("align.unpack", 8.0, 8.5),
            _span("align.stitch", 8.5, 9.5),
        ]),
        _phase("graph_trim", 10.0, 12.0),
        _phase("graph_cleaning", 12.0, 20.0, [
            _span("clean.build", 12.0, 13.0),
            _span("clean.bubbles", 13.0, 16.0, path_search=1.0, corrections=0.5),
            _span("clean.build", 16.0, 16.5),
        ]),
        _phase("write_outputs", 20.0, 20.25, output="corrected_gene_calls"),
        _phase("graph_prune", 20.25, 20.75),
        _phase("write_outputs", 20.75, 21.0, output="amira_results_tsv"),
        _phase("allele_polishing", 21.0, 23.0, [_kernels(21.5, 22.0, 500)]),
    ]
    second = [
        _phase("ingest_gene_calls", 0.0, 6.0, [
            _span("align.seed", 0.0, 2.0),
            _span("align.pack", 2.0, 2.5), _kernels(2.5, 3.0, 4_000), _span("align.unpack", 3.0, 3.5),
            _span("align.stitch", 3.5, 4.0),
        ]),
        _phase("graph_trim", 6.0, 7.0),
        _phase("graph_cleaning", 7.0, 9.0, [_span("clean.build", 7.0, 8.0)]),
        _phase("write_outputs", 9.0, 9.5, output="amira_results_tsv"),
    ]
    return {
        "reads": 100,
        "isolates": [
            _isolate(tmp_path, "first", first),
            _isolate(tmp_path, "second", second),
            _isolate(tmp_path, "failed", None),  # no file: skipped
        ],
        "trace": None,
    }


def test_phase_readers_are_means_over_isolates_with_the_file(run):
    # graph_trim + graph_prune: 2.5 and 1.0
    assert spec.reader("graph_trim_s")(run) == pytest.approx(1.75)
    # write_outputs, summed over its entries: 0.5 and 0.5
    assert spec.reader("writes_s")(run) == pytest.approx(0.5)


def test_cleaning_span_readers(run):
    assert spec.reader("cleaning_build_s")(run) == pytest.approx((1.5 + 1.0) / 2)
    # only the first isolate has bubbles: the mean is over it alone
    assert spec.reader("cleaning_bubbles_s")(run) == pytest.approx(3.0)


def test_qc_span_readers_read_under_the_qc_only(run):
    assert spec.reader("qc_seeding_s")(run) == pytest.approx((4.0 + 2.0) / 2)
    # pack + unpack + stitch: 3.0 and 1.5
    assert spec.reader("qc_align_host_s")(run) == pytest.approx(2.25)
    # polishing's align.kernels span is not the QC's: 2.5 and 0.5
    assert spec.reader("qc_kernel_wait_s")(run) == pytest.approx(1.5)


def test_readers_with_nothing_to_read_return_none(tmp_path):
    without = {"isolates": [
        _isolate(tmp_path, "none", None),
        # a program with phases but without stamps, spans or these names
        _isolate(tmp_path, "old", [{"phase": "graph_cleaning", "seconds": 2.0}]),
    ], "trace": None}
    for name in ("graph_trim_s", "writes_s", "cleaning_build_s", "cleaning_bubbles_s",
                 "qc_seeding_s", "qc_align_host_s", "qc_kernel_wait_s", "sw_dp_gcells_per_s"):
        assert spec.reader(name)(without) is None, name


def test_sw_dp_gcells_per_s_reads_the_cells_over_the_kernels_device_time(run):
    assert spec.reader("sw_dp_gcells_per_s")(run) is None  # no trace
    records = [
        ("void sw_dp_kernel<8>(...)", 100.0, 100.5),
        ("void sw_traceback_kernel<256>(...)", 100.5, 100.6),
    ]
    run["trace"] = devtrace.summarise(records, 99.0, 110.0, [])
    # 1,000 + 2,000 + 500 + 4,000 live cells in 0.5 s of sw_dp_kernel
    assert spec.reader("sw_dp_gcells_per_s")(run) == pytest.approx(7_500 / 0.5 / 1e9)
    # 39 operations a cell over the int32 peak is the roofline's share
    import bounds

    kernel_bounds = {"sw_dp": 7_500 * bounds.SW_DP_OPS_PER_CELL / bounds.INT32_OPS_PER_S * 1e3,
                     "sw_traceback": 0.0}
    roofline = spec.reader("sw_dp_roofline")(dict(run, kernel_bounds_ms=kernel_bounds))
    gcells = spec.reader("sw_dp_gcells_per_s")(run)
    assert gcells * 39 / 16_727 * 100 == pytest.approx(roofline, rel=1e-3)
    run["trace"] = devtrace.summarise(records[1:], 99.0, 110.0, [])
    assert spec.reader("sw_dp_gcells_per_s")(run) is None  # no sw_dp time
