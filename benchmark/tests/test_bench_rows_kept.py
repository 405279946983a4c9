"""`sw_dp_rows_kept_pct` on fake runs: the rows the aligner sent over the
jobs' whole query rows, summed over every `align.kernels` span of every
isolate, and nothing from a program whose spans lack the counters."""

from __future__ import annotations

import json

import pytest

import spec


def _kernels(**counters):
    return {"span": "align.kernels", "start_ns": 0, "end_ns": 1, "seconds": 0.0,
            "counters": dict(launches=1, jobs=2, live_cells=0, tb_steps=0, **counters)}


def _run(tmp_path, isolates):
    recs = []
    for i, spans in enumerate(isolates):
        out = tmp_path / f"iso{i}"
        out.mkdir()
        phases = [{"phase": name, "start_ns": 0, "end_ns": 1, "seconds": 0.0, "spans": s}
                  for name, s in spans]
        (out / "phase_timings.json").write_text(json.dumps(phases))
        recs.append({"out": str(out), "phases": [], "wall_s": 1.0})
    return {"isolates": recs, "trace": None}


def test_rows_kept_over_rows_full_over_every_span(tmp_path):
    run = _run(tmp_path, [
        [("ingest_gene_calls", [_kernels(rows_full=30_000, rows_kept=2_400),
                                _kernels(rows_full=10_000, rows_kept=1_000)]),
         ("allele_polishing", [_kernels(rows_full=3_000, rows_kept=2_900)])],
        [("allele_polishing", [_kernels(rows_full=7_000, rows_kept=6_700)])],
    ])
    assert spec.reader("sw_dp_rows_kept_pct")(run) == pytest.approx(
        100 * (2_400 + 1_000 + 2_900 + 6_700) / (30_000 + 10_000 + 3_000 + 7_000)
    )


def test_spans_without_the_counters_give_nothing(tmp_path):
    run = _run(tmp_path, [[("ingest_gene_calls", [_kernels(), _kernels()])]])
    assert spec.reader("sw_dp_rows_kept_pct")(run) is None
