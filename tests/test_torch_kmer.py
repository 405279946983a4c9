"""The port's k-mer engine (`amira_tpu_torch.ops.kmer`) against the JAX
package's host counter: the dense torch table (run here on CPU tensors at
k = 7 and 9) and the host counter (k = 7 and 15) give the same histogram,
query counts, per-read-set depth and overall depth. The dense histogram's
exact tail past its bin cap is exercised with a small cap, and the chunked
feed (native packer and its Python fallback, mid-read chunk cuts) is held
to a single-chunk count.

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
    no 2^26-code passes over a few kilobases. The reference is the JAX
    package's host counter (small inputs would take its sorted XLA path)."""
    monkeypatch.setattr(kmer, "_DENSE_CHUNK", 1 << 12)
    monkeypatch.setattr(jax_kmer, "_use_host_count", lambda n: True)


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
    "k,counter", [(7, "dense"), (9, "dense"), (7, "host"), (15, "host")]
)
def test_counts_histogram_and_queries_match_reference(k, counter):
    seqs = _seqs(seed=k, repeats=30)
    ref = jax_kmer.KmerCounter.from_sequences(seqs, k)
    if counter == "dense":
        got = _dense(seqs, k)
    else:
        got = kmer.KmerCounter.from_sequences(seqs, k, device="cpu")
    assert (got.dense is not None) == (counter == "dense")
    histo = got.histo()
    assert histo == ref.histo()
    assert list(histo) == sorted(histo)  # ascending, like the host counter
    queries = _seqs(seed=100 + k, n=10)
    np.testing.assert_array_equal(got.query_sequences(queries), ref.query_sequences(queries))
    for part in (queries[:1], queries[3:7], ["ACGT"], []):
        assert kmer.estimate_depth_for_reads(got, part) == jax_kmer.estimate_depth_for_reads(ref, part)


def test_dense_histogram_tail_past_cap(monkeypatch):
    seqs = _seqs(seed=1, repeats=40)
    ref = jax_kmer.KmerCounter.from_sequences(seqs, 7).histo()
    monkeypatch.setattr(kmer, "_HISTO_CAP", 4)
    got = _dense(seqs, 7).histo()
    assert max(got) > 4 * 8  # counts far past the cap resolve exactly
    assert got == ref
    assert list(got) == sorted(got)


def test_dense_min_count_filter_matches_host():
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


@pytest.mark.parametrize("k,counter", [(9, "dense"), (15, "host")])
def test_overall_read_depth_matches_reference(k, counter, tmp_path, monkeypatch):
    seqs = _isolate_seqs(tmp_path)
    ref_depth, ref_counter = jax_kmer.estimate_overall_read_depth(seqs, k)
    if counter == "dense":
        # the dense table is the cuda route; run it on CPU tensors here
        monkeypatch.setattr(
            kmer.KmerCounter, "from_sequences",
            classmethod(
                lambda cls, s, k, min_count=0, *, device:
                cls._from_seqs_dense(s, k, min_count, "cpu")
            ),
        )
    depth, got = kmer.estimate_overall_read_depth(seqs, k, device="cpu")
    assert (got.dense is not None) == (counter == "dense")
    assert depth == ref_depth
    assert got.histo() == ref_counter.histo()
    for part in (seqs[:5], seqs[10:30], seqs[-3:]):
        assert kmer.estimate_depth_for_reads(got, part) == jax_kmer.estimate_depth_for_reads(
            ref_counter, part
        )


def test_device_choice():
    seqs = _seqs(seed=5, n=5)
    before = dict(kmer.DENSE_TABLES)
    host = kmer.KmerCounter.from_sequences(seqs, 7, device="cpu")
    assert host.dense is None and kmer.DENSE_TABLES == before
    dense = _dense(seqs, 7)
    assert dense.dense.dtype == torch.int32 and dense.dense.shape == (4**7 + 1,)
    assert kmer.DENSE_TABLES["cpu"] == before["cpu"] + 1
