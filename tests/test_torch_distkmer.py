"""The port's bin-sharded DNA k-mer table (`amira_tpu_torch.parallel.
distgraph.distributed_kmer_count`, `make_distributed_kmer_step`) against
the JAX package's on the CPU.

Over D = 1, 2, 4 and 8 CPU shards the table equals JAX's over as many of
the 8 CPU devices of tests/conftest.py, bin for bin (the invalid-window bin
included), and the host counter on every k-mer; the inputs are those of
tests/test_parallel.py's two k-mer tests: N bases, sequence boundaries, a
sequence long enough to span shards, duplicates, and one 20k-base sequence
whose every cut falls inside it. The step's shards are the bin ranges of
JAX's psum_scatter output, and streaming a shard in pieces (the card's
_DENSE_CHUNK, cut down here) counts every window once.

Tolerance: zero; every comparison is exact.
"""

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JaxMesh

from amira_tpu.ops import kmer as jax_kmer
from amira_tpu.parallel import distgraph as jax_distgraph
from amira_tpu_torch.ops import kmer
from amira_tpu_torch.parallel import distgraph


def _mixed_seqs():
    """tests/test_parallel.py:test_distributed_kmer_count_matches_host_counter's
    sequences."""
    rng = np.random.RandomState(6)
    bases = np.array(list("ACGTN"))
    seqs = [
        "".join(rng.choice(bases, size=int(rng.randint(30, 600)),
                           p=[0.24, 0.24, 0.24, 0.24, 0.04]))
        for _ in range(80)
    ]
    seqs.append("".join(rng.choice(bases[:4], size=5000)))
    return seqs + seqs[:25]


def _one_long_seq():
    """tests/test_parallel.py:test_distributed_kmer_count_mid_sequence_cuts's."""
    rng = np.random.RandomState(11)
    return ["".join(rng.choice(list("ACGT"), size=20000))]


INPUTS = {"mixed": _mixed_seqs, "one_long_sequence": _one_long_seq}


@pytest.mark.parametrize("k", [7, 9])
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("name", list(INPUTS))
def test_distributed_kmer_count_equals_jax_and_host_counter(name, n_shards, k):
    seqs = INPUTS[name]()
    codes = kmer._concat_codes(seqs)
    assert np.array_equal(codes, jax_kmer._concat_codes(seqs))
    ref = jax_distgraph.distributed_kmer_count(codes, k, jax.devices()[:n_shards])
    got = distgraph.distributed_kmer_count(codes, k, ["cpu"] * n_shards)
    assert got.dtype == np.uint32 and got.shape == (4**k + 1,)
    assert np.array_equal(got, np.asarray(ref))
    host = kmer.KmerCounter.from_sequences(seqs, k, device="cpu")
    kmers = np.nonzero(got[:-1])[0]
    assert np.array_equal(kmers.astype(np.uint32), host.kmers)
    assert np.array_equal(got[kmers], host.counts.astype(np.uint32))
    if name == "one_long_sequence":
        assert int(got[:-1].sum()) == 20000 - k + 1  # every cut inside the sequence


@pytest.mark.parametrize("n_shards", [3, 8])
def test_step_shards_are_jax_bin_ranges(n_shards):
    seqs = _mixed_seqs()
    codes = kmer._concat_codes(seqs)
    k = 7
    words, bad, chunk = distgraph.kmer_rows(codes, k, n_shards)
    shards = distgraph.make_distributed_kmer_step(["cpu"] * n_shards, k, chunk)(words, bad)
    Tp, B = distgraph.kmer_layout(k, n_shards)
    assert Tp % n_shards == 0 and Tp >= 4**k + 1 and [s.shape[0] for s in shards] == [B] * n_shards
    jmesh = JaxMesh(np.array(jax.devices()[:n_shards]), ("kdata",))
    out = jax_distgraph.make_distributed_kmer_step(jmesh, k, chunk)(words, bad)
    by_index = {s.index[0].start or 0: np.asarray(s.data) for s in out.addressable_shards}
    assert sorted(by_index) == [d * B for d in range(n_shards)]
    for d, shard in enumerate(shards):
        assert np.array_equal(shard.numpy().view(np.uint32), by_index[d * B])


@pytest.mark.parametrize("piece", [64, 1008])
def test_streamed_pieces_count_every_window_once(monkeypatch, piece):
    seqs = _mixed_seqs()
    codes = kmer._concat_codes(seqs)
    whole = distgraph.distributed_kmer_count(codes, 9, ["cpu"] * 2)
    monkeypatch.setattr(kmer, "_DENSE_CHUNK", piece)
    streamed = distgraph.distributed_kmer_count(codes, 9, ["cpu"] * 2)
    assert np.array_equal(streamed, whole)
