"""End-to-end pipeline orchestration (the reference's __main__.py:417-804).

Stages: ingest pandora SAM/JSON -> gene filtering -> gene-mer graph build ->
trimming/junk removal -> k selection -> iterative cleaning (filter, correct,
tips, bubbles) -> final graph -> AMR path clustering -> per-allele polish +
closest-reference matching -> k-mer copy numbers -> filtered results TSV.

Port of `amira_tpu/pipeline.py`: every single-isolate route and mode
(pandora JSON or SAM gene calls, or pandora map; FASTQ reads or an
assembly; --meta, --promoter-mutations, --assemble-paths, --debug).
`args.device` (a torch device name: "cuda", "cuda:N" or "cpu") is
resolved once and passed down to the graph-build cache, the aligner (the
SAM route's consensus QC, polishing, promoters, path assembly) and the
k-mer table; the phase timer synchronises on its current stream. The
initial and final graph builds are distributed over every visible device
of that type when there are two or more (`parallel/distgraph.py`), unless
--no-dist-build is given; every other build is single-device, through the
build cache.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

from .graph_utils import (
    build_graph,
    choose_kmer_size,
    estimate_min_path_coverage,
    get_overall_mean_node_coverages,
    iterative_bubble_popping,
)
from .io import (
    parse_fasta,
    parse_fastq,
    plot_read_length_distribution,
    write_fastq,
    write_modified_fastq,
)
from .preprocess import (
    convert_pandora_output,
    estimate_mean_core_gene_counts,
    load_species_specific_files,
    process_pandora_json,
    process_reference_alleles,
    subsample_reads_and_estimate_read_depth,
)
from .results import (
    estimate_copy_numbers,
    filter_results,
    get_alleles,
    output_component_fastqs,
    process_reads,
    supplement_result_df,
    write_empty_result,
    write_fastqs_for_genes,
    write_fastqs_for_genes_with_short_reads,
    write_pandora_gene_calls,
    write_reads_per_AMR_gene,
)
from . import resolve_device, visible_devices
from .tracing import TIMER, phase
from .graph_cache import GraphBuildCache
from .parallel.distgraph import distributed_graph_build
from .vocab import GeneVocab


def run_pandora_map(
    pandora_path, panRG_path, readfile, outdir, cores, seed, assembly, species, meta
):
    """Shell out to the external pandora gene caller
    (pre_processing.py:13-35); its SAM/consensus are the ingestion contract."""
    import glob

    command = (
        f"{pandora_path} map -t {cores} --min-gene-coverage-proportion 0.5 "
        f"--max-covg 10000 -o {os.path.join(outdir, 'pandora_output')} "
        f"{panRG_path} {readfile} --rng-seed {seed} "
    )
    if assembly is not None or meta is True:
        command += "--no-gene-coverage-filtering"
    else:
        command += "--min-abs-gene-coverage 1"
    if not os.path.exists(panRG_path):
        sys.stderr.write("\namira-tpu: panRG file does not exist.\n")
        sys.exit(1)
    if ".panidx.zip" not in panRG_path:
        sys.stderr.write("\namira-tpu: panRG file does not end in .panidx.zip.\n")
        sys.exit(1)
    subprocess.run(command, shell=True, check=True)
    pandoraSam = glob.glob(
        os.path.join(outdir, "pandora_output", "*.filtered.sam")
    )[0]
    pandoraConsensus = os.path.join(
        outdir, "pandora_output", "pandora.consensus.fq.gz"
    )
    return pandoraSam, pandoraConsensus


def build_and_correct_graph(
    new_annotatedReads,
    new_gene_position_dict,
    node_min_coverage,
    fastq_content,
    output_dir,
    debug,
    overall_mean_node_coverages,
    cores,
    short_reads,
    short_read_gene_positions,
    sample_genesOfInterest,
    min_path_coverage,
    quiet,
    vocab,
    cache=None,
    device=None,
):
    """k=3 pre-clean + k selection + iterative bubble popping
    (__main__.py:337-414)."""
    with TIMER.span("clean.build"):
        graph = build_graph(new_annotatedReads, 3, new_gene_position_dict, vocab, cache, device)
    with TIMER.span("clean.short_reads"):
        short_reads.update(graph.get_short_read_annotations())
        short_read_gene_positions.update(graph.get_short_read_gene_positions())
    with TIMER.span("clean.filter_correct"):
        graph.remove_low_coverage_components(5)
        graph.filter_graph(node_min_coverage, 1)
        new_annotatedReads, new_gene_position_dict = graph.correct_reads(fastq_content)
    if debug:
        write_pandora_gene_calls(
            output_dir,
            new_gene_position_dict,
            new_annotatedReads,
            os.path.join(output_dir, "mid_correction_gene_calls.json"),
            os.path.join(output_dir, "mid_correction_gene_positions.json"),
        )
    with TIMER.span("clean.build"):
        graph = build_graph(new_annotatedReads, 3, new_gene_position_dict, vocab, cache, device)
    with TIMER.span("clean.short_reads"):
        short_reads.update(graph.get_short_read_annotations())
        short_read_gene_positions.update(graph.get_short_read_gene_positions())
    with TIMER.span("clean.filter_correct"):
        graph.filter_graph(node_min_coverage, 1)
        new_annotatedReads = graph.get_valid_reads_only()
    if len(new_annotatedReads) == 0:
        write_empty_result(output_dir)
        sys.exit(0)
    if not quiet:
        sys.stderr.write("\namira-tpu: selecting a gene-mer size (k).\n")
    with TIMER.span("clean.kmer_size"):
        geneMer_size = choose_kmer_size(
            overall_mean_node_coverages[3],
            new_annotatedReads,
            cores,
            new_gene_position_dict,
            sample_genesOfInterest,
            vocab,
            cache,
            device,
        )
    overall_mean_node_coverage = overall_mean_node_coverages[geneMer_size]
    if not quiet:
        sys.stderr.write(f"\namira-tpu: selected k={geneMer_size}.\n")
        sys.stderr.write(
            f"\namira-tpu: mean node depth = {overall_mean_node_coverage}.\n"
        )
    cleaning_iterations = 30
    new_annotatedReads, new_gene_position_dict = iterative_bubble_popping(
        new_annotatedReads,
        new_gene_position_dict,
        cleaning_iterations,
        geneMer_size,
        cores,
        short_reads,
        short_read_gene_positions,
        fastq_content,
        output_dir,
        node_min_coverage,
        sample_genesOfInterest,
        min_path_coverage,
        vocab,
        quiet,
        cache,
        device,
    )
    return (
        new_annotatedReads,
        new_gene_position_dict,
        geneMer_size,
        overall_mean_node_coverage,
    )


def run_pipeline(args) -> None:
    """The full pipeline (reference main(), __main__.py:417-804) on
    `args.device`. Every step from `TIMER.reset` to `TIMER.finish` lies in
    one top-level phase; each write of an output is a `write_outputs`
    phase of its own, named by its `output`."""
    start_time = time.time()
    device = resolve_device(getattr(args, "device", "cuda"))
    TIMER.reset(device)
    import random

    with phase("reference_setup"):
        random.seed(args.seed)
        os.makedirs(args.output_dir, exist_ok=True)
        AMR_gene_reference_FASTA, sequence_names, core_genes, plasmid_genes = (
            load_species_specific_files(
                args.species, args.amr_fasta, args.amr_calls, args.core_genes,
                args.plasmid_genes,
            )
        )
        reference_alleles, genesOfInterest = process_reference_alleles(
            AMR_gene_reference_FASTA, args.promoters
        )
        vocab = GeneVocab()
        build_cache = GraphBuildCache(device)
        # The initial and final builds are distributed by default when two or
        # more devices of --device's type are visible (the graph is identical
        # to the single-device build's; tests/test_torch_distgraph.py pins the
        # TSV); --no-dist-build opts out, and one device builds alone.
        dist_devices = (
            visible_devices(device.type) if args.dist_build is not False else []
        )
        use_dist = len(dist_devices) >= 2
    if args.reads is not None:
        if not args.quiet:
            sys.stderr.write("\namira-tpu: loading FASTQ file.\n")
        with phase("load_fastq"):
            fastq_content = parse_fastq(args.reads)
        with phase("write_outputs", output="reads_fastq_gz"):
            read_fastq_path, fastq_content = write_modified_fastq(
                fastq_content, args.reads, args.output_dir
            )
    else:
        if not args.quiet:
            sys.stderr.write("\namira-tpu: loading FASTA file.\n")
        with phase("load_assembly"):
            fastq_content = parse_fasta(args.assembly)
        read_fastq_path = os.path.join(args.output_dir, "assembly.fq.gz")
        with phase("write_outputs", output="assembly_fastq_gz"):
            write_fastq(read_fastq_path, fastq_content)

    pandoraSam = args.pandoraSam
    pandoraConsensus = args.pandoraConsensus
    if pandoraSam is None and args.pandoraJSON is None:
        if not args.quiet:
            sys.stderr.write("\namira-tpu: running Pandora map.\n")
        with phase("pandora_map"):
            pandoraSam, pandoraConsensus = run_pandora_map(
                args.pandora_path, args.panRG_path, read_fastq_path,
                args.output_dir, args.cores, args.seed, args.assembly,
                args.species, args.meta,
            )

    with phase("ingest_gene_calls"):
        if args.pandoraJSON:
            annotatedReads, sample_genesOfInterest, gene_position_dict = (
                process_pandora_json(
                    args.pandoraJSON, genesOfInterest, args.gene_positions
                )
            )
            annotatedReads = dict(sorted(annotatedReads.items()))
            mean_read_depth = estimate_mean_core_gene_counts(annotatedReads, core_genes)
            sys.stderr.write(f"\namira-tpu: mean read depth = {mean_read_depth}.\n")
        else:
            pandora_consensus = parse_fastq(pandoraConsensus)
            (
                annotatedReads,
                sample_genesOfInterest,
                gene_position_dict,
                consensus_depths,
            ) = convert_pandora_output(
                pandoraSam,
                pandora_consensus,
                genesOfInterest,
                args.gene_min_coverage,
                args.lower_gene_length_threshold,
                args.upper_gene_length_threshold,
                fastq_content,
                device=device,
            )
            annotatedReads = dict(sorted(annotatedReads.items()))
            if args.sample_reads is True:
                annotatedReads, mean_read_depth = (
                    subsample_reads_and_estimate_read_depth(
                        annotatedReads, args.sample_size, core_genes,
                        args.seed, consensus_depths,
                    )
                )
            else:
                mean_read_depth = estimate_mean_core_gene_counts(
                    annotatedReads, core_genes
                )
            write_pandora_gene_calls(
                args.output_dir,
                gene_position_dict,
                annotatedReads,
                os.path.join(args.output_dir, "gene_calls_with_gene_filtering.json"),
                os.path.join(args.output_dir, "gene_positions_with_gene_filtering.json"),
            )
            sys.stderr.write(
                f"\namira-tpu: mean read depth across core genes = {mean_read_depth}.\n"
            )
    if len(sample_genesOfInterest) == 0:
        write_empty_result(args.output_dir)
        sys.exit(0)
    if args.debug:
        with phase("write_outputs", output="read_length_plot"):
            plot_read_length_distribution(annotatedReads, args.output_dir)

    def _initial_or_final_build(reads_d, kk, pos_d):
        if use_dist:
            return distributed_graph_build(
                reads_d, kk, dist_devices, vocab=vocab, gene_positions=pos_d
            )
        return build_graph(reads_d, kk, pos_d, vocab, build_cache)

    if not args.quiet:
        sys.stderr.write("\namira-tpu: building initial gene-mer graph.\n")
    with phase("initial_graph_build", items=len(annotatedReads), unit="reads"):
        graph = _initial_or_final_build(annotatedReads, 3, gene_position_dict)
    with phase("graph_trim"):
        if args.debug:
            for node in graph.all_nodes():
                graph.color_node(node, sample_genesOfInterest)
            graph.generate_gml(
                os.path.join(args.output_dir, "pre_correction_gene_mer_graph"),
                3, 1, 1,
            )
            graph.get_unitigs_in_graph(
                os.path.join(args.output_dir, "pre_correction_unitigs.txt")
            )
        with TIMER.span("trim.coverages"):
            overall_mean_node_coverages = get_overall_mean_node_coverages(graph)
            short_reads = graph.get_short_read_annotations()
            short_read_gene_positions = graph.get_short_read_gene_positions()
        if not args.no_trim:
            with TIMER.span("trim.correct"):
                graph.remove_non_AMR_associated_nodes(sample_genesOfInterest)
                new_annotatedReads, new_gene_position_dict = graph.correct_reads(
                    fastq_content
                )
            with TIMER.span("trim.rebuild"):
                graph = build_graph(new_annotatedReads, 3, new_gene_position_dict, vocab, build_cache)
        else:
            new_annotatedReads = dict(annotatedReads)
            new_gene_position_dict = dict(gene_position_dict)
        with TIMER.span("trim.min_coverage"):
            try:
                min_path_coverage = estimate_min_path_coverage(
                    graph.get_all_node_coverages(),
                    os.path.join(args.output_dir, "initial_node_coverages.png")
                    if args.debug
                    else None,
                )
            except (ValueError, IndexError):
                min_path_coverage = 10
        node_min_coverage = args.node_min_coverage
        if args.reads is not None and args.meta is False:
            with TIMER.span("trim.junk_reads"):
                graph.filter_graph(2, 1)
                new_annotatedReads, new_gene_position_dict, _rej, _rejp = (
                    graph.remove_junk_reads(0.80)
                )
    if not args.quiet:
        sys.stderr.write(
            "\namira-tpu: removing low coverage components and nodes with "
            f"coverage < {node_min_coverage}.\n"
        )
    if args.reads is not None:
        with phase("graph_cleaning", items=len(new_annotatedReads), unit="reads"):
            (
                new_annotatedReads,
                new_gene_position_dict,
                geneMer_size,
                overall_mean_node_coverage,
            ) = build_and_correct_graph(
                new_annotatedReads,
                new_gene_position_dict,
                node_min_coverage,
                fastq_content,
                args.output_dir,
                args.debug,
                overall_mean_node_coverages,
                args.cores,
                short_reads,
                short_read_gene_positions,
                sample_genesOfInterest,
                min_path_coverage,
                args.quiet,
                vocab,
                build_cache,
            )
    else:
        geneMer_size = 3
        overall_mean_node_coverage = overall_mean_node_coverages[3]

    if not args.quiet:
        sys.stderr.write("\namira-tpu: building corrected gene-mer graph.\n")
    with phase("final_graph_build", items=len(new_annotatedReads), unit="reads"):
        graph = _initial_or_final_build(
            new_annotatedReads, geneMer_size, new_gene_position_dict
        )
    with phase("write_outputs", output="corrected_gene_calls"):
        write_pandora_gene_calls(
            args.output_dir,
            new_gene_position_dict,
            new_annotatedReads,
            os.path.join(args.output_dir, "corrected_gene_calls.json"),
            os.path.join(args.output_dir, "corrected_gene_positions.json"),
        )
    with phase("graph_prune"):
        short_reads.update(graph.get_short_read_annotations())
        short_read_gene_positions.update(graph.get_short_read_gene_positions())
        if args.reads is not None:
            graph.remove_low_coverage_components(5)
        if args.debug:
            for node in graph.all_nodes():
                graph.color_node(node, sample_genesOfInterest)
            graph.get_unitigs_in_graph(
                os.path.join(args.output_dir, "post_correction_unitigs.txt")
            )
    if not args.quiet:
        sys.stderr.write("\namira-tpu: writing gene-mer graph.\n")
    with phase("write_outputs", output="gene_mer_graph"):
        graph.generate_gml(
            os.path.join(args.output_dir, "gene_mer_graph"),
            geneMer_size,
            node_min_coverage,
            1,
        )
    if args.output_components is True:
        with phase("write_outputs", output="component_fastqs"):
            output_component_fastqs(args.output_dir, graph, fastq_content)
    if not args.quiet:
        sys.stderr.write("\namira-tpu: clustering reads.\n")
    with phase("path_clustering", items=len(sample_genesOfInterest), unit="genes"):
        clusters_to_add, clusters_of_interest, path_reads = process_reads(
            graph,
            sample_genesOfInterest,
            args.cores,
            short_reads,
            short_read_gene_positions,
            overall_mean_node_coverage,
        )
    if not args.quiet:
        sys.stderr.write("\namira-tpu: writing fastqs.\n")
    with phase("write_outputs", output="allele_fastqs"):
        os.makedirs(os.path.join(args.output_dir, "AMR_allele_fastqs"), exist_ok=True)
        (
            longest_reads_for_genes,
            supplemented_clusters,
            allele_component_mapping,
            files_to_assemble,
        ) = write_fastqs_for_genes(
            clusters_of_interest, overall_mean_node_coverage, fastq_content,
            args.output_dir,
        )
    with phase("write_outputs", output="allele_fastqs_short_reads"):
        longest_reads_for_genes, files_to_assemble = (
            write_fastqs_for_genes_with_short_reads(
                clusters_to_add,
                overall_mean_node_coverage,
                longest_reads_for_genes,
                args.output_dir,
                files_to_assemble,
                fastq_content,
                supplemented_clusters,
                allele_component_mapping,
            )
        )
        longest_read_lengths = {}
        for row in longest_reads_for_genes:
            longest_read_lengths[row.split("\n")[0].replace(">", "")] = len(
                "".join(row.split("\n")[1:])
            )
    if not args.quiet:
        sys.stderr.write("\namira-tpu: obtaining nucleotide sequences.\n")
    with phase(
        "allele_polishing", items=len(supplemented_clusters), unit="alleles"
    ):
        result_df = get_alleles(
            supplemented_clusters,
            args.output_dir,
            reference_alleles,
            sequence_names,
            fastq_content,
            args.identity,
            args.coverage,
            args.debug,
            device=device,
        )
    if len(result_df) == 0:
        write_empty_result(args.output_dir)
        sys.exit(0)
    if args.reads is not None and args.assembly is None and args.meta is False:
        if not args.quiet:
            sys.stderr.write("\namira-tpu: estimating cellular copy numbers.\n")
        with phase("copy_number_estimation", items=len(path_reads), unit="paths"):
            copy_numbers, mean_depth_per_reference = estimate_copy_numbers(
                fastq_content,
                path_reads,
                set(result_df.column("Amira allele")),
                args.output_dir,
                15,
                args.debug,
                device=device,
            )
    else:
        if not args.quiet:
            sys.stderr.write(
                "\namira-tpu: skipping cellular copy number estimation.\n"
            )
        copy_numbers = {a: "N/A" for a in result_df.column("Amira allele")}
        mean_depth_per_reference = dict(copy_numbers)
    if args.assemble_paths is True:
        from .assembly import assemble_full_length_paths

        with phase("path_assembly"):
            assemble_full_length_paths(args.output_dir, args.cores, device=device)
    with phase("result_table"):
        result_df = supplement_result_df(
            result_df, copy_numbers, mean_depth_per_reference, longest_read_lengths,
            args.debug,
        )
        if args.output_components is True:
            result_df.set_column(
                "Component ID",
                [allele_component_mapping[a] for a in result_df.column("Amira allele")],
            )
        result_df = filter_results(
            result_df,
            args.min_relative_depth,
            supplemented_clusters,
            annotatedReads,
            sample_genesOfInterest,
            args.identity,
            args.coverage,
            mean_read_depth,
            plasmid_genes,
            args.meta,
        )
        if args.promoters:
            from .promoters import genotype_promoters

            result_df = genotype_promoters(
                result_df,
                reference_alleles,
                os.path.join(args.output_dir, "AMR_allele_fastqs"),
                sequence_names,
                fastq_content,
                args.debug,
                args.output_components,
                device=device,
            )
        if args.debug:
            write_reads_per_AMR_gene(args.output_dir, supplemented_clusters)
        result_df = result_df.sort_by("Determinant name")
    with phase("write_outputs", output="amira_results_tsv"):
        result_df.write_tsv(os.path.join(args.output_dir, "amira_results.tsv"))
    TIMER.finish(args.output_dir, args.quiet)
    if not args.quiet:
        sys.stderr.write(
            f"\namira-tpu: total runtime {round(time.time() - start_time)} seconds.\n"
        )
