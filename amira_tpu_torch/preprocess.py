"""Input pre-processing: pandora SAM/JSON ingestion, gene filtering, species
assets, reference alleles, depth estimation.

Reference semantics: amira/pre_processing.py. Pandora itself stays external
(per the design north star, its SAM/JSON outputs are the ingestion contract);
the minimap2/samtools consensus-QC step is replaced by the in-process banded
SW aligner.
"""

from __future__ import annotations

import json
import os
import random
import sys

import numpy as np

from . import REFERENCE_PACKAGE_DIR
from .io import parse_sam


def clean_gene(g: str) -> str:
    """Strip punctuation from a gene name (pre_processing.py:38-41)."""
    chars_to_remove = set("|()-*+#:=/,'")
    return "".join(ch for ch in g if ch not in chars_to_remove)


def process_pandora_json(pandoraJSON, genesOfInterest, gene_positions):
    """JSON ingestion: keep reads containing AMR genes
    (pre_processing.py:44-63)."""
    with open(pandoraJSON) as i:
        annotatedReads = json.loads(i.read())
    with open(gene_positions) as i:
        gene_position_dict = json.loads(i.read())
    subsetted = set()
    for read in annotatedReads:
        for g in annotatedReads[read]:
            if g[1:] in genesOfInterest:
                subsetted.add(g[1:])
    return annotatedReads, list(subsetted), gene_position_dict


def get_read_start(cigar) -> int:
    """0-based read-region start from leading hard clips.

    NOTE: N leading hard-clipped bases yield start N-1, not N — this matches
    the reference exactly (pre_processing.py:66-73); downstream consumers
    (allele fastq slicing, position interpolation) share the same convention,
    so changing it would break output parity."""
    if cigar and cigar[0][0] == 5:
        return cigar[0][1] - 1
    return 0


def get_read_end(cigar, regionStart):
    regionLength = sum(n for op, n in cigar if op != 5)
    return regionStart + regionLength - 1, regionLength


def determine_gene_strand(record):
    strandless = (
        record.reference_name.replace("~~~", ";")
        .replace(".aln.fas", "")
        .replace(".fasta", "")
        .replace(".fa", "")
    )
    gene_name = ("+" if record.is_forward else "-") + strandless
    return gene_name, strandless


def remove_poorly_mapped_genes(
    pandora_consensus,
    zero_coverage_threshold,
    genesOfInterest,
    fastq_content,
    band_width=256,
    max_reads=None,
    *,
    device,
):
    """Drop non-AMR consensus genes with > threshold uncovered bases when the
    raw reads are aligned back to the pandora consensus
    (pre_processing.py:126-187) — minimap2/samtools replaced by the banded SW
    kernel. ALL reads are aligned (max_reads is a test hook), matching the
    reference's full-BAM pileup.

    Returns {gene: int32 per-base depth array} over the SURVIVING consensus
    genes — the in-memory equivalent of the reference's
    mapped_to_consensus.bam, consumed by get_core_gene_mean_depth
    (pre_processing.py:322-355 `samtools coverage` route). Depth accumulates
    per alignment reference span, like per-position read depth."""
    from .ops.align import Aligner

    genes = list(pandora_consensus.keys())
    if not genes or not fastq_content:
        return {}
    refs = {g: pandora_consensus[g]["sequence"] for g in genes}
    aligner = Aligner(refs, band_width=band_width, device=device)
    depth = {g: np.zeros(len(refs[g]), dtype=np.int32) for g in genes}
    read_ids = list(fastq_content.keys())
    if max_reads is not None and len(read_ids) > max_reads:
        rng = random.Random(0)
        read_ids = rng.sample(read_ids, max_reads)
    read_seqs = {rid: fastq_content[rid]["sequence"] for rid in read_ids}
    for _rid, hits in aligner.map_reads(read_seqs).items():
        for g, (_strand, aln) in hits.items():
            depth[g][aln.r_start : aln.r_end] += 1
    for g in genes:
        if g in genesOfInterest:
            continue
        d = depth[g]
        if (len(d) - int(np.count_nonzero(d))) / len(d) > zero_coverage_threshold:
            del pandora_consensus[g]
            del depth[g]
    return depth


def get_core_gene_mean_depth(consensus_depths, core_genes_path):
    """Mean over core genes of per-gene mean depth (`samtools coverage`
    meandepth over mapped_to_consensus.bam; pre_processing.py:322-355)."""
    with open(core_genes_path) as i:
        core = set(i.read().split("\n"))
    per_gene = [
        float(d.sum()) / len(d)
        for g, d in consensus_depths.items()
        if g in core and len(d)
    ]
    if per_gene:
        return float(np.mean(per_gene))
    return 0


def convert_pandora_output(
    pandoraSam,
    pandora_consensus,
    genesOfInterest,
    relativeMinGeneThreshold,
    gene_length_lower_threshold,
    gene_length_upper_threshold,
    fastq_content,
    *,
    device,
):
    """Parse the pandora pseudo-SAM into per-read gene calls + positions and
    filter rare genes (pre_processing.py:190-284)."""
    annotatedReads: dict = {}
    gene_position_dict: dict = {}
    geneCounts: dict = {}
    consensus_depths = remove_poorly_mapped_genes(
        pandora_consensus, 0.2, genesOfInterest, fastq_content, device=device
    )
    for read in parse_sam(pandoraSam):
        if not read.is_mapped:
            continue
        cigar = read.cigar
        regionStart = get_read_start(cigar)
        regionEnd, regionLength = get_read_end(cigar, regionStart)
        gene_name, strandless = determine_gene_strand(read)
        if strandless in genesOfInterest or (
            strandless in pandora_consensus
            and gene_length_lower_threshold
            * len(pandora_consensus[strandless]["sequence"])
            <= regionLength
            <= gene_length_upper_threshold
            * len(pandora_consensus[strandless]["sequence"])
        ):
            rn = read.query_name
            if rn not in annotatedReads:
                annotatedReads[rn] = []
                gene_position_dict[rn] = []
            geneCounts[strandless] = geneCounts.get(strandless, 0) + 1
            gene_position_dict[rn].append((regionStart, regionEnd))
            annotatedReads[rn].append(gene_name)
    geneMinCoverage = (
        float(np.mean(list(geneCounts.values()))) * relativeMinGeneThreshold
        if geneCounts
        else 0
    )
    subsettedGenesOfInterest = set()
    filtered_genes = set()
    for r in annotatedReads:
        new_calls, new_positions = [], []
        for i in range(len(annotatedReads[r])):
            gene = annotatedReads[r][i]
            if geneCounts[gene[1:]] >= geneMinCoverage:
                new_calls.append(gene)
                new_positions.append(gene_position_dict[r][i])
                if gene[1:] in genesOfInterest:
                    subsettedGenesOfInterest.add(gene[1:])
            else:
                if gene[1:] in genesOfInterest:
                    filtered_genes.add(gene[1:])
        annotatedReads[r] = new_calls
        gene_position_dict[r] = new_positions
    for g in filtered_genes:
        sys.stderr.write(
            f"\namira-tpu: filtering AMR gene {g} due to insufficient "
            f"frequency ({geneCounts[g]}).\n"
        )
    assert len(annotatedReads) != 0
    return (
        annotatedReads,
        subsettedGenesOfInterest,
        gene_position_dict,
        consensus_depths,
    )


def process_reference_alleles(path_to_interesting_genes, promoters=False):
    """Parse AMR_alleles_unified.fa (>gene;allele headers) into
    {gene: {allele: seq}} plus the AMR gene-name set
    (pre_processing.py:287-319)."""
    with open(path_to_interesting_genes) as i:
        reference_content = i.read().split(">")[1:]
    reference_alleles: dict = {}
    genesOfInterest = set()
    promoter_alleles = []
    for allele in reference_content:
        newline_split = allele.split("\n")
        assert newline_split[0].count(";") == 1, (
            "Reference FASTA headers can only contain 1 semicolon"
        )
        gene_name, allele_name = newline_split[0].split(";")
        sequence = "".join(newline_split[1:])
        if "promoter" in gene_name:
            promoter_alleles.append(
                (gene_name.replace("_promoter", ""), allele_name, sequence)
            )
            continue
        genesOfInterest.add(gene_name)
        reference_alleles.setdefault(gene_name, {})[allele_name] = sequence
    if promoters is True:
        promoters_to_add: dict = {}
        for gene_name in reference_alleles:
            for p_gene, p_allele, p_seq in promoter_alleles:
                if p_gene in gene_name:
                    promoter_name = gene_name + "_promoter"
                    promoters_to_add.setdefault(promoter_name, {})[p_allele] = p_seq
        reference_alleles.update(promoters_to_add)
    return reference_alleles, genesOfInterest


def load_species_specific_files(
    species, AMR_gene_reference_FASTA, sequence_names, core_genes, plasmid_genes,
    assets_dir=None,
):
    """Resolve per-species asset files (pre_processing.py:100-123). The asset
    root is the JAX package's assets/ dir (read by path), or
    $AMIRA_TPU_ASSETS."""
    if (
        AMR_gene_reference_FASTA is None
        or sequence_names is None
        or core_genes is None
    ):
        root = assets_dir or os.environ.get(
            "AMIRA_TPU_ASSETS",
            os.path.join(REFERENCE_PACKAGE_DIR, "assets"),
        )
        species_dir = os.path.join(root, species)
        if not os.path.exists(species_dir):
            sys.stderr.write(
                f"\namira-tpu: {species} is not a supported species name "
                f"(no assets at {species_dir}).\n"
            )
            sys.exit(1)
        if AMR_gene_reference_FASTA is None:
            AMR_gene_reference_FASTA = os.path.join(
                species_dir, "AMR_alleles_unified.fa"
            )
        if sequence_names is None:
            sequence_names = os.path.join(species_dir, "AMR_calls.json")
        if core_genes is None:
            core_genes = os.path.join(species_dir, "core_genes.txt")
        if plasmid_genes is None:
            plasmid_genes = os.path.join(species_dir, "plasmid_genes.txt")
    return AMR_gene_reference_FASTA, sequence_names, core_genes, plasmid_genes


def estimate_mean_core_gene_counts(annotatedReads, core_genes):
    """Mean per-gene call count over core genes (pre_processing.py:358-370)."""
    with open(core_genes) as i:
        core = set(i.read().split("\n"))
    counts: dict = {}
    for r in annotatedReads:
        for g in annotatedReads[r]:
            counts[g[1:]] = counts.get(g[1:], 0) + 1
    core_gene_counts = [counts[g] for g in counts if g in core]
    if len(core_gene_counts) > 0:
        return float(np.mean(core_gene_counts))
    return 0


def subsample_reads_and_estimate_read_depth(
    annotatedReads, sample_size, core_genes, seed=2025, consensus_depths=None
):
    """Random subsample to `sample_size` reads + core-gene depth estimate
    (pre_processing.py:373-389): when the read set was subsampled, depth
    comes from core-gene call counts; otherwise from the reads->consensus
    per-base pileup (the reference's `samtools coverage` route via
    mapped_to_consensus.bam)."""
    total_reads = len(annotatedReads)
    if total_reads > sample_size:
        rng = random.Random(seed)
        annotatedReads = dict(rng.sample(list(annotatedReads.items()), sample_size))
        mean_read_depth = estimate_mean_core_gene_counts(annotatedReads, core_genes)
    elif consensus_depths is not None:
        mean_read_depth = get_core_gene_mean_depth(consensus_depths, core_genes)
    else:
        mean_read_depth = estimate_mean_core_gene_counts(annotatedReads, core_genes)
    return annotatedReads, mean_read_depth
