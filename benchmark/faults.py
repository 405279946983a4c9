"""Faults planted in the program from outside, to show that `correct`
catches them. Neither the benchmark's runs nor its metrics use them: the
control readings (`readings.py`) and the fault tests do. A name may join
several with "+", planted together.

- polish_unchanged: polishing's consensus step returns the draft it was
  given, so the allele stays its closest reference (a step that returns
  its state unchanged). This is also the control: the answer without the
  guarantee that the allele is the isolate's own.
- copy_number_doubled: the k-mer depth of an allele's reads comes back
  doubled where it is produced (an answer altered).
- closest_reference_swapped: the references that align to a polished
  allele come back in reverse order, so the row names the farthest (an
  answer altered).
- row_dropped: the result table loses its last row (an answer left out).
- row_duplicated: every row of the result table comes twice (an answer
  altered: each gene copy reported twice).
- half_jobs: the aligner runs the jobs of every other read of a batch and
  drops the rest (half of the batch left out): polishing sees half its
  reads, the SAM route's QC half the depth.
- cleaning_skipped: graph cleaning returns the reads it was given, with
  pandora's miscalls in them (a step that returns its state unchanged).
- writes_dropped: the corrected gene calls and the gene-mer graph's GML
  are not written (outputs left out).
- qc_unaligned: the consensus QC aligns no read (a step that returns its
  state unchanged: every gene's depth stays 0).
"""

from __future__ import annotations

import contextlib

NAMES = (
    "polish_unchanged",
    "copy_number_doubled",
    "closest_reference_swapped",
    "row_dropped",
    "row_duplicated",
    "half_jobs",
    "cleaning_skipped",
    "writes_dropped",
    "qc_unaligned",
)


def _patch(name: str):
    """(object, attribute, replacement) of one fault, or a list of them."""
    import os

    from amira_tpu_torch import graph, pipeline, preprocess, results
    from amira_tpu_torch.ops import align

    if name == "polish_unchanged":
        return results, "consensus_from_alignments", lambda draft, alignments: draft
    if name == "copy_number_doubled":
        real = results.estimate_depth_for_reads
        return results, "estimate_depth_for_reads", lambda c, seqs: 2.0 * real(c, seqs)
    if name == "closest_reference_swapped":
        real = results.polished_entries_from_hits
        return results, "polished_entries_from_hits", lambda *a: real(*a)[::-1]
    if name == "row_dropped":
        real = pipeline.filter_results

        def dropped(*a, **k):
            table = real(*a, **k)
            return table.select([i < len(table) - 1 for i in range(len(table))])

        return pipeline, "filter_results", dropped
    if name == "row_duplicated":
        real = pipeline.filter_results

        def doubled(*a, **k):
            table = real(*a, **k)
            return table.append_rows(table.rows)

        return pipeline, "filter_results", doubled
    if name == "cleaning_skipped":

        def skipped(reads, positions, _min_cov, _fq, _out, _debug, coverages, *a, **k):
            return reads, positions, 3, coverages[3]

        return pipeline, "build_and_correct_graph", skipped
    if name == "writes_dropped":
        real = pipeline.write_pandora_gene_calls

        def calls_dropped(out_dir, positions, calls, calls_path, positions_path):
            if os.path.basename(calls_path) != "corrected_gene_calls.json":
                real(out_dir, positions, calls, calls_path, positions_path)

        return [
            (pipeline, "write_pandora_gene_calls", calls_dropped),
            (graph.GeneMerGraph, "generate_gml", lambda self, *a, **k: None),
        ]
    if name == "half_jobs":
        real = align.Aligner._run_jobs

        def halved(self, jobs):
            reads = {}
            for job in jobs:
                reads.setdefault(job[0][0], len(reads))
            return real(self, [j for j in jobs if reads[j[0][0]] % 2 == 0])

        return align.Aligner, "_run_jobs", halved
    if name == "qc_unaligned":
        real = preprocess.remove_poorly_mapped_genes
        return preprocess, "remove_poorly_mapped_genes", lambda *a, **k: real(*a, **dict(k, max_reads=0))
    raise ValueError(f"unknown fault {name!r} (known: {NAMES})")


def _patches(name: str) -> list:
    found = _patch(name)
    return found if isinstance(found, list) else [found]


@contextlib.contextmanager
def planted(names: str | None):
    patches = [p for n in names.split("+") for p in _patches(n)] if names else []
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    try:
        for obj, attr, fake in patches:
            setattr(obj, attr, fake)
        yield
    finally:
        for obj, attr, real in reversed(saved):
            setattr(obj, attr, real)
