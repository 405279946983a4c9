"""The port's tracing (`amira_tpu_torch.tracing`): phases, child spans and
counters on one clock, per thread, and the spans the pipeline opens.

A span lands under the innermost open phase or span of its thread, inside
its parent's stamps, and never in the flat list of phases; counters add up
in the innermost open entry; with no phase open nothing is recorded; no
span synchronises the device; a torch op run inside a span has its
`torch.profiler` record inside the span's stamps (the shared clock). On a
tiny isolate through the CLI's SAM route every top-level phase of the run
appears, cleaning holds its `clean.*` spans, and the consensus QC holds
`align.*` spans whose `align.kernels` counters equal the launches' own
inputs and outputs, recorded around `sw_batch.sw_dp`/`sw_traceback`, and
count fewer query rows sent than the jobs' reads hold.
Path clustering opens `cluster.gene_paths`, `cluster.split` and
`cluster.components` for each AMR gene, with the counters `genes`, `paths`
and `alleles`, and synchronises nothing.

Tolerance: zero; counts are compared exactly.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
import threading
import time

import pytest
import torch

from amira_tpu_torch import cluster
from amira_tpu_torch.graph import GeneMerGraph
from amira_tpu_torch.ops import sw_batch
from amira_tpu_torch.tracing import TIMER
from synthetic import make_isolate
from test_sam_ingestion import _write_consensus, _write_pandora_sam

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the top-level phases of a FASTQ run through the SAM route at the CLI's
# defaults, in the order they end (write_outputs once for each write)
SAM_ROUTE_PHASES = [
    ("reference_setup", None),
    ("load_fastq", None),
    ("write_outputs", "reads_fastq_gz"),
    ("ingest_gene_calls", None),
    ("initial_graph_build", None),
    ("graph_trim", None),
    ("graph_cleaning", None),
    ("final_graph_build", None),
    ("write_outputs", "corrected_gene_calls"),
    ("graph_prune", None),
    ("write_outputs", "gene_mer_graph"),
    ("path_clustering", None),
    ("write_outputs", "allele_fastqs"),
    ("write_outputs", "allele_fastqs_short_reads"),
    ("allele_polishing", None),
    ("copy_number_estimation", None),
    ("result_table", None),
    ("write_outputs", "amira_results_tsv"),
]


def _spans(entry, name=None):
    """Every span under `entry`, at any depth (named `name`, if given)."""
    for s in entry.get("spans", []):
        if name is None or s["span"] == name:
            yield s
        yield from _spans(s, name)


def _stamped_inside(parent):
    """Every child's stamps lie inside its parent's, at every depth."""
    for s in parent.get("spans", []):
        assert parent["start_ns"] <= s["start_ns"] <= s["end_ns"] <= parent["end_ns"]
        assert s["seconds"] == round((s["end_ns"] - s["start_ns"]) / 1e9, 6)
        _stamped_inside(s)


def test_a_span_lands_under_its_parent_and_never_synchronises(monkeypatch):
    syncs = []
    monkeypatch.setattr(TIMER, "_sync", lambda: syncs.append(1))
    TIMER.reset(None)
    with TIMER.phase("p", items=3):
        with TIMER.span("a"):
            with TIMER.span("a.inner"):
                pass
        with TIMER.span("b"):
            pass
    assert len(syncs) == 2  # the phase's two edges, and no span
    (p,) = TIMER.phases
    assert [p["phase"] for p in TIMER.phases] == ["p"]
    assert [s["span"] for s in p["spans"]] == ["a", "b"]
    assert [s["span"] for s in p["spans"][0]["spans"]] == ["a.inner"]
    assert "spans" not in p["spans"][1]
    _stamped_inside(p)
    assert p["seconds"] == round((p["end_ns"] - p["start_ns"]) / 1e9, 3)
    assert p["items"] == 3 and "items_per_sec" in p


def test_counters_add_up_in_the_innermost_open_entry():
    TIMER.reset(None)
    with TIMER.phase("p"):
        TIMER.count("in_phase")
        with TIMER.span("s"):
            TIMER.count("n", 2)
            TIMER.count("n", 3)
            TIMER.count("seconds", 0.25)
            with TIMER.span("t"):
                TIMER.count("n")
        with TIMER.span("s"):
            TIMER.count("n", 7)
        TIMER.count("in_phase", 4)
    (p,) = TIMER.phases
    assert p["counters"] == {"in_phase": 5}
    first, second = p["spans"]
    assert first["counters"] == {"n": 5, "seconds": 0.25}
    assert first["spans"][0]["counters"] == {"n": 1}
    assert second["counters"] == {"n": 7}


def test_a_span_with_no_phase_open_records_nothing():
    TIMER.reset(None)
    with TIMER.span("s"):
        TIMER.count("n")
        with TIMER.span("t"):
            pass
    assert TIMER.phases == []
    with TIMER.phase("p"):
        pass
    assert "spans" not in TIMER.phases[0] and "counters" not in TIMER.phases[0]


def test_phases_spans_and_counters_are_per_thread_under_contention():
    """Threads that time phases and spans at once each see their own phases,
    spans and counters (more threads than cores, a short switch interval)."""
    n_threads, n_phases = 24, 40
    errors = []

    def work(t):
        try:
            TIMER.reset(None)
            for i in range(n_phases):
                with TIMER.phase(f"t{t}.outer{i}", items=t):
                    with TIMER.phase(f"t{t}.inner{i}"):
                        with TIMER.span(f"t{t}.span{i}"):
                            TIMER.count("n", t)
                        TIMER.count("n", 1)
            want = [n for i in range(n_phases) for n in (f"t{t}.inner{i}", f"t{t}.outer{i}")]
            assert [p["phase"] for p in TIMER.phases] == want
            for i, inner in enumerate(TIMER.phases[0::2]):
                assert inner["counters"] == {"n": 1}
                (s,) = inner["spans"]
                assert s["span"] == f"t{t}.span{i}" and s["counters"] == {"n": t}
            assert all("spans" not in outer for outer in TIMER.phases[1::2])
        except AssertionError as e:  # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []


def test_spans_share_the_profilers_clock():
    """A torch op's profiler record (kineto's start_ns, the stamps the
    device records carry too) falls inside the span it ran in."""
    from torch.profiler import ProfilerActivity, profile

    TIMER.reset(None)
    x = torch.ones(4096)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TIMER.phase("p"):
            for i in range(3):
                with TIMER.span(f"s{i}"):
                    torch.mul(x, float(i))
    records = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mul"]
    spans = TIMER.phases[0]["spans"]
    assert len(records) == len(spans) == 3
    for e, s in zip(sorted(records, key=lambda e: e.start_ns()), spans):
        assert s["start_ns"] <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= s["end_ns"]


def array_graph():
    """A graph of two contexts of one AMR array (amrA, amrB), the second
    with amrC after it: reads and positions as pandora's JSON gives them."""
    arr = ["+amrA", "+amrB"]
    reads = {}
    for i in range(6):
        reads[f"r{i}"] = ["+g1", "-g2", "+g3", "+g4"] + arr + ["+g5", "-g6"]
        reads[f"s{i}"] = ["+g9", "-g10", "+g11", "+g12"] + arr + ["+amrC", "+g13", "-g14"]
    positions = {r: [(j * 100, j * 100 + 99) for j in range(len(g))] for r, g in reads.items()}
    return GeneMerGraph(reads, 3, positions, device="cpu")


def test_path_clustering_spans_nest_count_and_never_synchronise(monkeypatch):
    graph = array_graph()
    syncs = []
    monkeypatch.setattr(TIMER, "_sync", lambda: syncs.append(1))
    TIMER.reset(None)
    t0 = time.time_ns()
    with TIMER.phase("path_clustering"):
        clustered, _path_reads = cluster.assign_reads_to_genes(
            graph, ["amrC", "amrA", "amrB", "absent"], 1, {}, graph.get_mean_node_coverage()
        )
    t1 = time.time_ns()
    assert len(syncs) == 2  # the phase's two edges, and no span
    (p,) = TIMER.phases
    _stamped_inside(p)
    assert t0 <= p["start_ns"] <= p["end_ns"] <= t1
    # one gene at a time, in sorted order; a gene with no node opens none
    assert p["counters"] == {"genes": 3}
    names = ["cluster.gene_paths", "cluster.split", "cluster.components"]
    assert [s["span"] for s in p["spans"]] == names * 3
    paths = [s["counters"]["paths"] for s in p["spans"][0::3]]
    alleles = [s["counters"]["alleles"] for s in p["spans"][1::3]]
    assert paths == [2, 2, 1] and alleles == [2, 2, 1]
    assert "counters" not in p["spans"][2]
    # every allele kept is placed in a component, and no component is left
    # for the sweep to fill
    placed = [a for comp in clustered.values() for by_gene in comp.values() for a in by_gene]
    assert len(placed) == sum(alleles) == 5


def _bounds():
    """The benchmark's `bounds.py` (live cells of a sw_dp launch)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_bounds", os.path.join(REPO, "benchmark", "bounds.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def sam_run(tmp_path_factory):
    """A tiny isolate through the CLI's SAM route on the CPU, not quiet,
    with each SW launch's inputs and steps recorded beside the phase it ran
    in. Returns (phase_timings.json, the launches, the CLI's stderr)."""
    from amira_tpu_torch.__main__ import main

    d = tmp_path_factory.mktemp("tracing")
    files = make_isolate(str(d / "data"), seed=41, n_reads=70)
    files["sam"] = str(d / "data" / "pandora.filtered.sam")
    files["consensus"] = str(d / "data" / "pandora.consensus.fq.gz")
    _write_pandora_sam(files, files["sam"])
    _write_consensus(files, files["consensus"])
    out = str(d / "out")
    argv = [
        "--pandoraSam", files["sam"], "--pandoraConsensus", files["consensus"],
        "--reads", files["fastq"], "--species", "Escherichia_coli",
        "--amr-fasta", files["amr_fasta"], "--amr-calls", files["amr_calls"],
        "--core-genes", files["core_genes"], "--plasmid-genes", files["plasmid_genes"],
        "--output", out, "--device", "cpu",
    ]
    launches = []
    real_dp, real_tb = sw_batch.sw_dp, sw_batch.sw_traceback

    def sw_dp(qs, rs, qlens, dlos, W):
        launches.append({"phase": TIMER._local.stack[0]["phase"], "qlens": qlens.clone(), "W": W})
        return real_dp(qs, rs, qlens, dlos, W)

    def sw_traceback(*args):
        packed, n_steps, q0, r0 = real_tb(*args)
        launches[-1]["tb_steps"] = int(n_steps.sum())
        return packed, n_steps, q0, r0

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    err = io.StringIO()
    sw_batch.sw_dp, sw_batch.sw_traceback = sw_dp, sw_traceback
    try:
        with contextlib.redirect_stderr(err):
            main(argv)
    finally:
        sw_batch.sw_dp, sw_batch.sw_traceback = real_dp, real_tb
        torch.set_num_threads(n)
    with open(os.path.join(out, "phase_timings.json")) as f:
        return json.load(f), launches, err.getvalue()


def test_every_step_of_the_run_lies_in_a_stamped_phase(sam_run):
    phases, _launches, _err = sam_run
    assert [(p["phase"], p.get("output")) for p in phases] == SAM_ROUTE_PHASES
    for before, after in zip(phases, phases[1:]):
        assert before["end_ns"] <= after["start_ns"]
    for p in phases:
        _stamped_inside(p)


def test_cleaning_trim_and_copy_number_hold_their_stage_spans(sam_run):
    phases, _launches, _err = sam_run
    (cleaning,) = [p for p in phases if p["phase"] == "graph_cleaning"]
    names = {s["span"] for s in cleaning["spans"]}
    assert {"clean.build", "clean.filter_correct", "clean.tips", "clean.bubbles",
            "clean.kmer_size", "clean.short_reads"} == names
    # the sweep's stage seconds, where it found components to search
    for s in _spans(cleaning, "clean.bubbles"):
        assert set(s.get("counters", {})) <= {"path_search", "path_filter", "sketches", "corrections"}
    (trim,) = [p for p in phases if p["phase"] == "graph_trim"]
    assert [s["span"] for s in trim["spans"]] == [
        "trim.coverages", "trim.correct", "trim.rebuild", "trim.min_coverage", "trim.junk_reads"
    ]
    (cn,) = [p for p in phases if p["phase"] == "copy_number_estimation"]
    assert [s["span"] for s in cn["spans"]] == [
        "copy_number.path_fastqs", "copy_number.count", "copy_number.queries"
    ]


def test_path_clustering_holds_its_spans_and_the_table_prints_them(sam_run):
    phases, _launches, err = sam_run
    (clustering,) = [p for p in phases if p["phase"] == "path_clustering"]
    names = [s["span"] for s in clustering["spans"]]
    genes = clustering["counters"]["genes"]
    assert genes >= 1
    assert names == ["cluster.gene_paths", "cluster.split", "cluster.components"] * genes
    assert all("paths" in s["counters"] for s in _spans(clustering, "cluster.gene_paths"))
    assert all("alleles" in s["counters"] for s in _spans(clustering, "cluster.split"))
    table = err[err.index("amira-tpu phase timings:"):]
    assert "\n  path_clustering " in table
    for name in ("cluster.gene_paths", "cluster.split", "cluster.components"):
        assert f"\n    {name}" in table


def test_qc_align_spans_count_the_launches_work(sam_run):
    """`align.kernels` under the consensus QC counts exactly the launches
    made there: one each, their jobs, the live cells of bounds.dp_bound and
    the traceback's steps."""
    phases, launches, err = sam_run
    (qc,) = [p for p in phases if p["phase"] == "ingest_gene_calls"]
    names = [s["span"] for s in qc["spans"]]
    assert names[0] == "align.seed" and names[-1] == "align.stitch"
    assert set(names[1:-1]) == {"align.pack", "align.kernels", "align.unpack"}
    kernels = list(_spans(qc, "align.kernels"))
    own = [ln for ln in launches if ln["phase"] == "ingest_gene_calls"]
    assert kernels and len(kernels) == len(own)
    bounds = _bounds()
    total = lambda key: sum(s["counters"][key] for s in kernels)  # noqa: E731
    assert total("launches") == len(own)
    assert total("jobs") == sum(ln["qlens"].numel() for ln in own)
    assert total("live_cells") == sum(bounds.dp_bound(ln["qlens"], ln["W"])[0] for ln in own)
    assert total("tb_steps") == sum(ln["tb_steps"] for ln in own)
    # the operator's table: the phase, then its spans merged by name
    table = err[err.index("amira-tpu phase timings:"):]
    assert "\n  ingest_gene_calls " in table
    assert "\n    align.kernels" in table and f"x{len(kernels)}  launches={len(own)}," in table


def test_qc_align_spans_count_the_rows_kept(sam_run):
    """Each `align.kernels` span under the consensus QC counts its jobs'
    whole query rows (`rows_full`) and the rows sent (`rows_kept`), whose
    cells are `live_cells`. The fixture's reads hold 3-6 genes of 500 bp
    (make_isolate's defaults) and its consensus genes are 500 bp, so every
    job's read is longer than the rows its band can reach: fewer are kept,
    at most a gene plus the band a job."""
    phases, launches, _err = sam_run
    (qc,) = [p for p in phases if p["phase"] == "ingest_gene_calls"]
    kernels = list(_spans(qc, "align.kernels"))
    own = [ln for ln in launches if ln["phase"] == "ingest_gene_calls"]
    assert kernels and len(kernels) == len(own)
    for span, ln in zip(kernels, own):
        c = span["counters"]
        assert c["rows_kept"] == int(ln["qlens"].sum())
        assert c["rows_kept"] * ln["W"] == c["live_cells"]
        assert c["rows_kept"] < c["rows_full"]
        assert int(ln["qlens"].max()) <= 500 + ln["W"] - 1
