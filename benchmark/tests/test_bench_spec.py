"""The loader finds every configuration, cell and metric by name, and
BENCHMARK.json keeps to the shape the harness relies on."""

from __future__ import annotations

import json
import re

import pytest

import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = spec.benchmark()


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    entry, params = spec.cell(cell)
    assert entry["name"] == cell and NAME.match(cell)
    assert params["name"] == entry["config"]
    for key in ("route", "reads", "sub", "indel", "call_noise", "genes_per_read", "limits", "defaults"):
        assert key in params, key
    numbers = {
        "copies_missing", "copies_extra", "rows_repeated", "refs_off", "allele_edits",
        "copy_number_gap", "writes_missing",
    }
    if params["route"] == "sam":
        numbers |= {"calls_off", "qc_depth_gap"}
    assert set(params["limits"]) == numbers


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_every_metric_has_a_reader(kind):
    for m in BENCH[kind]:
        assert NAME.match(m["name"])
        assert callable(spec.reader(m["name"]))
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in BENCH["workloads"]}


def test_configs_match_their_files():
    for c in BENCH["configs"]:
        with open(spec.ROOT / c["file"]) as f:
            data = json.load(f)
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.cell("no_such.cell")
