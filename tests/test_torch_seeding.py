"""The port's seeding (`Aligner._jobs_for`, one seed index over every
reference) against the JAX package's (a `_seed_chains` call per
reference): the same alignment jobs, element for element and in order.

References are random, with k-mers shared between references, tandem
repeats whose k-mers occur more than `max_occ` times in one reference, and
reads that carry a gap wider than half the band (so that one reference
gives two chains), in both orientations; reads are also restricted to
subsets of the references (`allowed`, the `ref_subsets` of `map_reads`),
in an order of their own. A hypothesis test draws such sets. Many reads
seeded in one `map_reads` call, in one device pass or in several, give the
JAX package's jobs of each read in turn, and `align.seed` counts the
passes, k-mers, hits and jobs of the call.

Tolerance: zero; job lists are compared with ==.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from amira_tpu.ops.align import Aligner as JaxAligner
from amira_tpu_torch.ops import align as port_align
from amira_tpu_torch.ops.align import Aligner as PortAligner
from amira_tpu_torch.ops.align import reverse_complement
from amira_tpu_torch.tracing import TIMER

BASES = np.array(list("ACGT"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain SW versions run many small torch ops: one intra-op thread
    is as fast here, and keeps parallel test workers off each other's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _seq(rng, n):
    return "".join(rng.choice(BASES, size=n))


def _references(rng, n_refs, min_len=60, max_len=400):
    refs = {}
    for i in range(n_refs):
        kind = i % 4
        if kind == 3:  # a tandem repeat: each k-mer seen more than max_occ times
            unit = _seq(rng, int(rng.randint(15, 40)))
            refs[f"rep{i}"] = (unit * 30)[: int(rng.randint(200, 500))]
        else:
            refs[f"g{i}"] = _seq(rng, int(rng.randint(min_len, max_len)))
    names = list(refs)
    for _ in range(n_refs // 3 if n_refs > 1 else 0):  # segments shared between references
        a, b = rng.choice(names, size=2, replace=False)
        seg = refs[a][: int(rng.randint(20, 60))]
        at = int(rng.randint(0, len(refs[b])))
        refs[b] = refs[b][:at] + seg + refs[b][at:]
    return refs


def _read(rng, refs, band_width):
    """A read over a few references' sequences with noise, one of them with
    a gap wider than half the band, on a random strand."""
    names = list(refs)
    parts = []
    for name in rng.choice(names, size=min(len(names), int(rng.randint(1, 5))), replace=False):
        s = list(refs[name])
        for p in range(0, len(s), int(rng.randint(9, 30))):
            s[p] = str(rng.choice(BASES))
        s = "".join(s)
        if rng.rand() < 0.5 and len(s) > 3 * band_width // 4 + 40:
            cut = int(rng.randint(20, len(s) - band_width // 2 - 20))
            s = s[:cut] + s[cut + band_width // 2 + 10 :]
        elif rng.rand() < 0.5:
            s = s[:40] + _seq(rng, band_width // 2 + 8) + s[40:]
        parts.append(s)
        parts.append(_seq(rng, int(rng.randint(0, 50))))
    read = "".join(parts)
    return reverse_complement(read) if rng.rand() < 0.4 else read


def _compare(seed, n_refs, band_width, n_reads=4):
    rng = np.random.RandomState(seed)
    refs = _references(rng, n_refs)
    jax_al = JaxAligner(refs, band_width=band_width)
    port_al = PortAligner(refs, band_width=band_width, device="cpu")
    n_jobs = split = 0
    for r in range(n_reads):
        read = _read(rng, refs, band_width)
        for min_seeds in (1, 2, 5):
            ref = jax_al._jobs_for(f"r{r}", read, min_seeds)
            assert port_al._jobs_for(f"r{r}", read, min_seeds) == ref
            n_jobs += len(ref)
            tags = [(j[0], j[1]) for j in ref]
            split += len(tags) - len(set(tags))  # a reference with two chains
        names = list(refs)
        allowed = [names[i] for i in rng.permutation(len(names))[: int(rng.randint(1, len(names) + 1))]]
        ref = jax_al._jobs_for(f"r{r}", read, 2, allowed)
        assert port_al._jobs_for(f"r{r}", read, 2, allowed) == ref
    return n_jobs, split


def test_jobs_match_jax_with_shared_kmers_repeats_and_split_chains():
    n_jobs, split = _compare(seed=3, n_refs=12, band_width=64, n_reads=6)
    assert n_jobs > 20 and split > 0


def test_jobs_match_jax_on_genes_of_one_genome():
    """Reads over a genome of 60 genes, one gene sharing a k-mer with
    another, one tandem-repeat gene: the consensus QC's situation."""
    rng = np.random.RandomState(11)
    refs = {f"gene{i}": _seq(rng, 400) for i in range(60)}
    refs["gene7"] = refs["gene3"][100:160] + refs["gene7"][60:]
    refs["rep"] = _seq(rng, 30) * 14
    genome = "".join(refs.values())
    jax_al = JaxAligner(refs)
    port_al = PortAligner(refs, device="cpu")
    for r in range(3):
        start = int(rng.randint(0, len(genome) - 3000))
        read = genome[start : start + 3000]
        ref = jax_al._jobs_for("read", read, 2)
        assert port_al._jobs_for("read", read, 2) == ref
        assert len({j[0][1] for j in ref}) >= 5


def test_map_reads_with_ref_subsets_matches_jax(monkeypatch):
    monkeypatch.setenv("AMIRA_TPU_SW_ENGINE", "xla")
    rng = np.random.RandomState(5)
    refs = _references(rng, 6, 80, 200)
    reads = {f"r{i}": _read(rng, refs, 64) for i in range(4)}
    names = list(refs)
    subsets = {rid: names[i % 3 :: 2] for i, rid in enumerate(reads)}
    jax_hits = JaxAligner(refs, band_width=64).map_reads(dict(reads), ref_subsets=subsets)
    port_hits = PortAligner(refs, band_width=64, device="cpu").map_reads(
        dict(reads), ref_subsets=subsets
    )
    assert port_hits.keys() == jax_hits.keys()
    for rid in port_hits:
        assert set(port_hits[rid]) <= set(subsets[rid])
        assert {n: (s, vars(a)) for n, (s, a) in port_hits[rid].items()} == {
            n: (s, vars(a)) for n, (s, a) in jax_hits[rid].items()
        }


@settings(
    max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow],
    derandomize=True,
)
@given(
    seed=st.integers(0, 2**31 - 1),
    n_refs=st.integers(1, 10),
    band_width=st.sampled_from([64, 128, 256]),
)
def test_jobs_match_jax_on_drawn_reference_sets(seed, n_refs, band_width):
    _compare(seed, n_refs, band_width, n_reads=2)


def test_secondary_chain_at_the_support_ratio_is_kept():
    """A primary chain of 40 seeds and a secondary of 2, 46 diagonals away
    (more than half of a 64-lane band): 2 * 20 == 40, so the secondary
    chain is just kept, giving the reference two jobs on that strand."""
    rng = np.random.RandomState(4)
    ref = _seq(rng, 400)
    read = ref[:54] + _seq(rng, 100) + ref[200:216]
    refs = {"ref": ref, "other": _seq(rng, 300)}
    jobs = JaxAligner(refs, band_width=64)._jobs_for("r", read, 2)
    assert PortAligner(refs, band_width=64, device="cpu")._jobs_for("r", read, 2) == jobs
    assert [(j[0][1], j[1], j[3]) for j in jobs] == [("ref", "+", 0), ("ref", "+", 46)]


def _many_reads(rng, refs, band_width):
    """Reads for one `map_reads` call: reads over the references, one with
    runs of N, one shorter than k, one with no hits, one over a tandem
    repeat whose k-mers occur more than max_occ times in its reference."""
    reads = {f"r{i}": _read(rng, refs, band_width) for i in range(6)}
    n_read = list(_read(rng, refs, band_width))
    for at in (5, len(n_read) // 2, len(n_read) - 30):
        n_read[at : at + 7] = "N" * 7
    reads["with_n"] = "".join(n_read)
    reads["short"] = _seq(rng, 9)
    reads["no_hits"] = _seq(rng, 150)
    gene = next(n for n in refs if n.startswith("g"))
    reads["repeat"] = refs["tandem"][:300] + refs[gene]
    reads["r_last"] = _read(rng, refs, band_width)
    return reads


@pytest.mark.parametrize("passes", ["one", "several"])
@pytest.mark.parametrize("band_width", [64, 256])
@pytest.mark.parametrize("min_seeds", [1, 2])
@pytest.mark.parametrize("subsets", [False, True])
def test_map_reads_seeds_many_reads_as_jax_does_each(
    monkeypatch, subsets, min_seeds, band_width, passes
):
    """The jobs that one `map_reads` call hands to the batches equal the
    JAX package's `_jobs_for` of each read in turn, concatenated: with and
    without `ref_subsets` (subsets in an order of their own, one empty,
    one read left out), and in one pass or in several, one of which holds
    consecutive reads."""
    rng = np.random.RandomState(100 * min_seeds + band_width + 7 * subsets)
    refs = _references(rng, 8)
    refs["tandem"] = _seq(rng, 20) * 20  # each k-mer 19 or 20 times
    reads = _many_reads(rng, refs, band_width)
    names = list(refs)
    ref_subsets = None
    if subsets:
        ref_subsets = {
            rid: [names[j] for j in rng.permutation(len(names))[: int(rng.randint(1, len(names) + 1))]]
            for rid in reads
        }
        ref_subsets["r1"] = sorted(names, reverse=True)
        ref_subsets["r2"] = []
        del ref_subsets["r3"]
    jax_al = JaxAligner(refs, band_width=band_width)
    expected = []
    for rid, seq in reads.items():
        allowed = None if ref_subsets is None else ref_subsets.get(rid)
        expected.extend(jax_al._jobs_for(rid, seq, min_seeds, allowed))
    assert jax_al._jobs_for("no_hits", reads["no_hits"], 1) == []
    assert jax_al._jobs_for("short", reads["short"], 1) == []
    assert jax_al._jobs_for("with_n", reads["with_n"], 1)
    repeat_refs = {j[0][1] for j in jax_al._jobs_for("repeat", reads["repeat"], 1)}
    assert repeat_refs and "tandem" not in repeat_refs

    port_al = PortAligner(refs, band_width=band_width, device="cpu")
    if passes == "several":
        monkeypatch.setattr(port_align, "SEED_PASS_BASES", sum(map(len, reads.values())) // 4)
    pass_reads = []
    seed_pass = port_al._seed_pass
    monkeypatch.setattr(
        port_al, "_seed_pass",
        lambda items, *a: pass_reads.append(len(items)) or seed_pass(items, *a),
    )
    got = []
    monkeypatch.setattr(port_al, "_run_jobs", lambda jobs: got.extend(jobs) or [])
    assert port_al.map_reads(dict(reads), min_seeds, ref_subsets) == {}
    assert got == expected
    assert sum(pass_reads) == len(reads)
    if passes == "one":
        assert pass_reads == [len(reads)]
    else:
        assert len(pass_reads) >= 3 and max(pass_reads) >= 2


def _spans(entry, name):
    for span in entry.get("spans", []):
        if span["span"] == name:
            yield span
        yield from _spans(span, name)


def test_align_seed_counts_passes_kmers_hits_and_jobs(monkeypatch):
    """A traced `map_reads` under an open phase: `align.seed` carries
    `seed_passes`, `seed_kmers`, `seed_hits` and `seed_jobs`, and its jobs
    are the `jobs` of the call's `align.kernels` spans."""
    rng = np.random.RandomState(9)
    refs = _references(rng, 4, 80, 160)
    reads = {f"r{i}": _read(rng, refs, 64) for i in range(3)}
    reads["short"] = _seq(rng, 9)
    al = PortAligner(refs, band_width=64, device="cpu")
    monkeypatch.setattr(port_align, "SEED_PASS_BASES", len(reads["r0"]) + len(reads["r1"]))
    TIMER.reset(None)
    with TIMER.phase("p"):
        al.map_reads(dict(reads))
    (p,) = TIMER.phases
    (seed,) = _spans(p, "align.seed")
    c = seed["counters"]
    assert set(c) == {"seed_passes", "seed_kmers", "seed_hits", "seed_jobs"}
    assert c["seed_passes"] == 2
    valid = sum(max(len(s) - 14, 0) for s in reads.values())
    assert c["seed_kmers"] == 2 * valid
    assert 0 < c["seed_jobs"] <= c["seed_hits"]
    kernels = list(_spans(p, "align.kernels"))
    assert kernels and c["seed_jobs"] == sum(s["counters"]["jobs"] for s in kernels)


def _seed_counters(al, reads, ref_subsets, monkeypatch):
    """The jobs a traced `map_reads` call hands to the batches, and its
    `align.seed` counters."""
    got = []
    monkeypatch.setattr(al, "_run_jobs", lambda jobs: got.extend(jobs) or [])
    TIMER.reset(None)
    with TIMER.phase("p"):
        assert al.map_reads(dict(reads), 2, ref_subsets) == {}
    (p,) = TIMER.phases
    (seed,) = _spans(p, "align.seed")
    return got, seed["counters"]


@pytest.mark.parametrize("subsets", [False, True])
def test_passes_split_by_hits_when_alleles_share_every_kmer(monkeypatch, subsets):
    """Polishing's situation: reads of a gene against the union of its many
    near-identical alleles, whose k-mers are shared by all of them, so a
    pass has many hits for few bases. Lowering SEED_PASS_HITS splits the
    pass into several at read boundaries, before any hit is expanded; the
    jobs stay the JAX package's, and the hits the same in all."""
    rng = np.random.RandomState(21)
    base = list(_seq(rng, 600))
    refs = {}
    for a in range(40):
        allele = list(base)
        for p in rng.choice(len(base), size=3, replace=False):
            allele[p] = str(rng.choice(BASES))
        refs[f"gene_{a}"] = "".join(allele)
    refs["other"] = _seq(rng, 500)
    names = list(refs)
    reads = {}
    for i in range(10):
        s = list(refs[names[int(rng.randint(0, 40))]][int(rng.randint(0, 80)) :])
        for p in range(0, len(s), int(rng.randint(15, 40))):
            s[p] = str(rng.choice(BASES))
        read = "".join(s)
        reads[f"r{i}"] = reverse_complement(read) if i % 3 == 0 else read
    ref_subsets = None
    if subsets:
        ref_subsets = {rid: [names[j] for j in rng.permutation(40)] for rid in reads}
        ref_subsets["r4"] = ["other", *names[5:1:-1]]
    jax_al = JaxAligner(refs, band_width=256)
    expected = []
    for rid, seq in reads.items():
        expected.extend(
            jax_al._jobs_for(rid, seq, 2, None if ref_subsets is None else ref_subsets[rid])
        )
    whole, whole_c = _seed_counters(
        PortAligner(refs, band_width=256, device="cpu"), reads, ref_subsets, monkeypatch
    )
    assert whole == expected and whole_c["seed_passes"] == 1
    # over ten hits a k-mer of the read's strand (seed_kmers counts both)
    assert whole_c["seed_hits"] > 5 * whole_c["seed_kmers"]
    monkeypatch.setattr(port_align, "SEED_PASS_HITS", whole_c["seed_hits"] // 4)
    split, split_c = _seed_counters(
        PortAligner(refs, band_width=256, device="cpu"), reads, ref_subsets, monkeypatch
    )
    assert split == expected
    assert split_c["seed_passes"] >= 4
    assert {k: split_c[k] for k in ("seed_kmers", "seed_hits", "seed_jobs")} == {
        k: whole_c[k] for k in ("seed_kmers", "seed_hits", "seed_jobs")
    }
