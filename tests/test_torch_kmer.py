"""The port's k-mer engine (`amira_tpu_torch.ops.kmer`) against the JAX
package's: the sorted counter (the cuda route below 2^24 codes, run here
on CPU tensors at k = 7, 9 and 15) against JAX's sorted route
(`_count_kernel`, which JAX takes on the CPU for small read sets), and the
dense torch table (the cuda route from 2^24 codes, run here on CPU tensors
at k = 7 and 9) and the host counter (k = 7 and 15) against JAX's host
counter. All give the same k-mers, counts, histogram, query counts,
per-read-set depth and overall depth, on empty, all-N and shorter-than-k
inputs too. The choice between counters is pinned at its 2^24 edge on
cuda, and at every size on the CPU (the host counter). The
dense histogram's exact tail past its bin cap is exercised with a small
cap, and the chunked feed (native packer and its Python fallback, mid-read
chunk cuts) is held to a single-chunk count.

Tolerance: zero; counts are integers and depths are halves of integer sums.
"""

import numpy as np
import pytest
import torch

from amira_tpu.ops import kmer as jax_kmer
from amira_tpu_torch.ops import kmer
from synthetic import make_isolate


@pytest.fixture(autouse=True)
def small_dense_chunks(monkeypatch):
    """Stream the dense table in small chunks: many chunks per count, and
    no 2^26-code passes over a few kilobases."""
    monkeypatch.setattr(kmer, "_DENSE_CHUNK", 1 << 12)


@pytest.fixture
def jax_host_counter(monkeypatch):
    """The reference of the port's dense and host counters: the JAX
    package's host counter (small inputs would take its sorted XLA path)."""
    monkeypatch.setattr(jax_kmer, "_use_host_count", lambda n: True)


@pytest.fixture
def jax_sorted_launches(monkeypatch):
    """Counts the JAX package's sorted-route compactions, without changing
    them: a sorted case shows that its reference took that route."""
    calls = []
    real = jax_kmer._compact_count_kernel

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(jax_kmer, "_compact_count_kernel", counting)
    return calls


@pytest.fixture
def port_sorted(monkeypatch):
    """The sorted counter is the cuda route below 2^24 codes; run it on CPU
    tensors here."""
    monkeypatch.setattr(kmer, "counter_for", lambda device_type, n_codes: "sorted")


def _port_counter(counter, monkeypatch, request):
    """Makes the port take `counter` on CPU tensors, and the JAX package
    its matching route."""
    if counter == "sorted":
        request.getfixturevalue("port_sorted")
        return request.getfixturevalue("jax_sorted_launches")
    request.getfixturevalue("jax_host_counter")
    if counter == "dense":
        # the dense table is the cuda route; run it on CPU tensors here
        monkeypatch.setattr(kmer, "counter_for", lambda device_type, n_codes: "dense")
    return None


def _seqs(seed=0, n=60, L=(80, 400), repeats=0):
    rng = np.random.RandomState(seed)
    genome = "".join(rng.choice(list("ACGT"), size=3000))
    out = []
    for _ in range(n):
        s = rng.randint(0, len(genome) - L[1])
        seq = list(genome[s : s + rng.randint(*L)])
        for j in rng.choice(len(seq), size=len(seq) // 30, replace=False):
            seq[j] = rng.choice(list("ACGTN"))
        out.append("".join(seq))
    # a repeated read drives some counts far above the rest
    out += [out[0]] * repeats
    return out


def _isolate_seqs(tmp_path):
    from amira_tpu_torch.io import parse_fastq

    files = make_isolate(str(tmp_path / "iso"), seed=4, n_reads=40)
    return [v["sequence"] for v in parse_fastq(files["fastq"]).values()]


def _dense(seqs, k, min_count=0):
    return kmer.KmerCounter._from_seqs_dense(seqs, k, min_count, "cpu")


@pytest.mark.parametrize(
    "k,counter",
    [(7, "dense"), (9, "dense"), (7, "host"), (15, "host"),
     (7, "sorted"), (9, "sorted"), (15, "sorted")],
)
def test_counts_histogram_and_queries_match_reference(k, counter, monkeypatch, request):
    seqs = _seqs(seed=k, repeats=30)
    jax_sorted = _port_counter(counter, monkeypatch, request)
    ref = jax_kmer.KmerCounter.from_sequences(seqs, k)
    sorted_before = kmer.SORTED_TABLES["cpu"]
    got = kmer.KmerCounter.from_sequences(seqs, k, device="cpu")
    assert (got.dense is not None) == (counter == "dense")
    assert kmer.SORTED_TABLES["cpu"] - sorted_before == (counter == "sorted")
    if counter != "dense":
        assert got.kmers.dtype == ref.kmers.dtype and got.counts.dtype == ref.counts.dtype
        np.testing.assert_array_equal(got.kmers, ref.kmers)
        np.testing.assert_array_equal(got.counts, ref.counts)
    if jax_sorted is not None:
        assert len(jax_sorted) == 1
    histo = got.histo()
    assert histo == ref.histo()
    assert list(histo) == sorted(histo)  # ascending, like the host counter
    queries = _seqs(seed=100 + k, n=10)
    np.testing.assert_array_equal(got.query_sequences(queries), ref.query_sequences(queries))
    for part in (queries[:1], queries[3:7], ["ACGT"], []):
        assert kmer.estimate_depth_for_reads(got, part) == jax_kmer.estimate_depth_for_reads(ref, part)


def test_dense_histogram_tail_past_cap(monkeypatch, jax_host_counter):
    seqs = _seqs(seed=1, repeats=40)
    ref = jax_kmer.KmerCounter.from_sequences(seqs, 7).histo()
    monkeypatch.setattr(kmer, "_HISTO_CAP", 4)
    got = _dense(seqs, 7).histo()
    assert max(got) > 4 * 8  # counts far past the cap resolve exactly
    assert got == ref
    assert list(got) == sorted(got)


def test_dense_min_count_filter_matches_host(jax_host_counter):
    seqs = _seqs(seed=2, repeats=5)
    ref = jax_kmer.KmerCounter.from_sequences(seqs, 9, min_count=3)
    got = _dense(seqs, 9, min_count=3)
    assert got.histo() == ref.histo()
    assert int(got.dense[-1]) == 0  # the invalid-window bin is dropped


@pytest.mark.parametrize("chunk", [64, 1 << 16])
def test_chunked_feeds_equal_one_stream(chunk, monkeypatch):
    seqs = _seqs(seed=3, L=(100, 300))
    full = torch.zeros(4**7 + 1, dtype=torch.int32)
    kmer.KmerCounter._count_codes_dense(full, kmer._concat_codes(seqs), 7)
    monkeypatch.setattr(kmer, "_DENSE_CHUNK", chunk)  # cuts reads mid-way
    native = _dense(seqs, 7).dense
    fallback = torch.zeros(4**7 + 1, dtype=torch.int32)
    kmer.KmerCounter._count_codes_dense(fallback, kmer._concat_codes(seqs), 7)
    assert torch.equal(native[:-1], full[:-1])
    assert torch.equal(fallback[:-1], full[:-1])


@pytest.mark.parametrize(
    "k,counter", [(9, "dense"), (15, "host"), (9, "sorted"), (15, "sorted")]
)
def test_overall_read_depth_matches_reference(k, counter, tmp_path, monkeypatch, request):
    seqs = _isolate_seqs(tmp_path)
    jax_sorted = _port_counter(counter, monkeypatch, request)
    ref_depth, ref_counter = jax_kmer.estimate_overall_read_depth(seqs, k)
    depth, got = kmer.estimate_overall_read_depth(seqs, k, device="cpu")
    assert (got.dense is not None) == (counter == "dense")
    assert depth == ref_depth
    assert got.histo() == ref_counter.histo()
    if counter != "dense":
        # the filtered table of a sorted or host count is filtered on the host
        np.testing.assert_array_equal(got.kmers, ref_counter.kmers)
        np.testing.assert_array_equal(got.counts, ref_counter.counts)
    if jax_sorted is not None:
        assert len(jax_sorted) == 1
    for part in (seqs[:5], seqs[10:30], seqs[-3:]):
        assert kmer.estimate_depth_for_reads(got, part) == jax_kmer.estimate_depth_for_reads(
            ref_counter, part
        )


def test_device_choice():
    seqs = _seqs(seed=5, n=5)
    before = dict(kmer.DENSE_TABLES)
    sorted_before = kmer.SORTED_TABLES["cpu"]
    host = kmer.KmerCounter.from_sequences(seqs, 7, device="cpu")
    assert host.dense is None and kmer.DENSE_TABLES == before
    assert kmer.SORTED_TABLES["cpu"] == sorted_before
    dense = _dense(seqs, 7)
    assert dense.dense.dtype == torch.int32 and dense.dense.shape == (4**7 + 1,)
    assert kmer.DENSE_TABLES["cpu"] == before["cpu"] + 1


@pytest.mark.parametrize(
    "device_type,n_codes,counter",
    [
        ("cuda", (1 << 24) - 1, "sorted"),
        ("cuda", 1 << 24, "dense"),
        ("cpu", 1 << 20, "host"),
        ("cpu", 1 << 24, "host"),
    ],
)
def test_counter_choice_edges(device_type, n_codes, counter):
    """Sorted below 2^24 codes on the card (JAX: `_use_dense_device_count`
    declines below 2^24, `_use_host_count` only above 2^25), and the host
    counter at every size on the CPU (small and large sides of both of
    JAX's CPU and device edges)."""
    assert kmer.counter_for(device_type, n_codes) == counter

@pytest.mark.parametrize("case", ["empty", "all_n", "shorter_than_k", "mixed"])
@pytest.mark.parametrize("k", [7, 15])
def test_sorted_counter_edge_inputs(case, k, port_sorted, jax_sorted_launches):
    seqs = {
        "empty": [],
        "all_n": ["N" * 40, "NNNN" * 9],
        "shorter_than_k": ["ACGTA", "GG", "T" * (k - 1)],
        "mixed": ["N" * 30, "ACG", "", _seqs(seed=k, n=1)[0], "ACGTN" * 9],
    }[case]
    ref = jax_kmer.KmerCounter.from_sequences(seqs, k)
    got = kmer.KmerCounter.from_sequences(seqs, k, device="cpu")
    assert got.kmers.dtype == np.uint32 and got.counts.dtype == np.int64
    np.testing.assert_array_equal(got.kmers, ref.kmers)
    np.testing.assert_array_equal(got.counts, ref.counts)
    assert got.histo() == ref.histo()
    np.testing.assert_array_equal(got.query_sequences(seqs), ref.query_sequences(seqs))
    assert kmer.estimate_depth_for_reads(got, seqs) == jax_kmer.estimate_depth_for_reads(ref, seqs)
    assert (len(got.kmers) > 0) == (case == "mixed")
    assert len(jax_sorted_launches) == (case == "mixed")


@pytest.mark.parametrize("k", [9, 15])
def test_sorted_min_count_matches_reference(k, port_sorted, jax_sorted_launches):
    seqs = _seqs(seed=20 + k, repeats=6)
    ref = jax_kmer.KmerCounter.from_sequences(seqs, k, min_count=3)
    got = kmer.KmerCounter.from_sequences(seqs, k, min_count=3, device="cpu")
    assert len(jax_sorted_launches) == 1
    np.testing.assert_array_equal(got.kmers, ref.kmers)
    np.testing.assert_array_equal(got.counts, ref.counts)
    assert got.counts.min() >= 3
