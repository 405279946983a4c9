"""The clustering span readers on hand-written phase_timings.json files,
and the cells that carry them found by name."""

from __future__ import annotations

import json

import pytest

import spec

S = 1_000_000_000  # nanoseconds a second


def _entry(kind, name, start, end, spans=(), **counters):
    entry = {kind: name, "start_ns": int(start * S), "end_ns": int(end * S), "seconds": end - start}
    if spans:
        entry["spans"] = list(spans)
    if counters:
        entry["counters"] = counters
    return entry


def _gene(start, paths, split, components):
    """One gene's three spans, back to back from `start`."""
    a, b, c = start + paths, start + paths + split, start + paths + split + components
    return [
        _entry("span", "cluster.gene_paths", start, a, paths=2),
        _entry("span", "cluster.split", a, b, alleles=2),
        _entry("span", "cluster.components", b, c),
    ]


def _isolate(tmp_path, name, phases):
    out = tmp_path / name
    out.mkdir()
    if phases is not None:
        (out / "phase_timings.json").write_text(json.dumps(phases))
    return {"out": str(out), "phases": [], "wall_s": 1.0}


def test_clustering_span_readers_are_means_over_isolates(tmp_path):
    first = [
        _entry("phase", "graph_cleaning", 0.0, 5.0, [_entry("span", "cluster.split", 1.0, 2.0)]),
        _entry("phase", "path_clustering", 10.0, 12.0,
               _gene(10.0, 0.5, 0.25, 0.125) + _gene(11.0, 0.25, 0.125, 0.0625), genes=2),
    ]
    second = [_entry("phase", "path_clustering", 0.0, 1.0, _gene(0.0, 0.75, 0.0625, 0.0), genes=1)]
    run = {"isolates": [
        _isolate(tmp_path, "first", first),
        _isolate(tmp_path, "second", second),
        _isolate(tmp_path, "failed", None),
    ], "trace": None}
    # a span named alike under another phase is not read
    assert spec.reader("cluster_gene_paths_s")(run) == pytest.approx((0.75 + 0.75) / 2)
    assert spec.reader("cluster_split_s")(run) == pytest.approx((0.375 + 0.0625) / 2)


def test_clustering_span_readers_without_spans_return_none(tmp_path):
    # the parent program: the phase without child spans
    run = {"isolates": [
        _isolate(tmp_path, "old", [_entry("phase", "path_clustering", 0.0, 1.0)]),
    ], "trace": None}
    assert spec.reader("cluster_gene_paths_s")(run) is None
    assert spec.reader("cluster_split_s")(run) is None


@pytest.mark.parametrize("cell", ["ecoli_calls.accurate50k", "kpn_mdr.noisy50k"])
def test_new_cells_load_by_name(cell):
    entry, params = spec.cell(cell)
    assert entry["chips"] == 1 and params["route"] == "json" and params["reads"] == 50_000
    names = {m["name"] for m in spec.metrics_of(cell, "per_layer")}
    assert {"cluster_gene_paths_s", "cluster_split_s", "clustering_s", "polishing_s"} <= names
    assert not any(n.startswith("qc_") for n in names)
    if cell.startswith("kpn_mdr"):
        copies = sum(len(loci) for loci in params["amr_after"].values())
        assert (params["species"], params["genes"], copies) == ("Klebsiella_pneumoniae", 5300, 15)
    else:
        assert (params["sub"], params["indel"], params["call_noise"]) == (0.005, 0.005, 0.01)
