"""Two processes over torch.distributed (`amira_tpu_torch.parallel.
multiproc`), the port's twin of tests/test_dcn_multiprocess.py.

Two worker processes (gloo, four CPU shards each) join one process group
and run the ("host", "data", "table") = (2, 2, 2) count step with "host"
on the process boundary, and the k-mer step with its bins spread over all
eight shards, on the JAX two-process test's inputs. Each process's count
table equals JAX's serial `local_genemer_tables`, JAX's 3D step on 8 CPU
devices and the port's 3D step in one process; each process's bin range
equals the host counter (checked in the worker) and, by digest, the
port's one-process step and JAX's table. A hang fails the test. The
worker's reference bin range is held to JAX's counter with each of the
port's counters forced in turn. "nccl" with two ranks on one device
raises before any process starts.

Tolerance: zero; every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from amira_tpu.ops import kmer as jax_kmer
from amira_tpu.parallel import distgraph as jax_distgraph
from amira_tpu_torch.ops import kmer
from amira_tpu_torch.parallel import distgraph, multiproc
from amira_tpu_torch.parallel.mesh import Mesh


def test_two_process_gloo_run_equals_jax_and_one_process(tmp_path):
    results = multiproc.run_workers(str(tmp_path), "gloo", ["cpu", "cpu"], timeout=300)
    (tokens, lengths, k, capacity), (seqs, kk) = multiproc.dcn_inputs()

    tk, tc, _ek, _ec = (np.asarray(x) for x in jax_distgraph.local_genemer_tables(
        tokens, lengths, k, 1 << 12
    ))
    serial = dict(zip(tk[tk != 0].tolist(), tc[tk != 0].tolist()))
    jmesh = JaxMesh(np.array(jax.devices()[:8]).reshape(2, 2, 2), ("host", "data", "table"))
    jk, jc, jt = jax_distgraph.distributed_node_counts_3d(tokens, lengths, k, jmesh, capacity)
    one = distgraph.distributed_node_counts_3d(
        tokens, lengths, k, Mesh([[["cpu"] * 2] * 2] * 2, ("host", "data", "table")), capacity
    )
    expected_total = int(np.maximum(lengths - (k - 1), 0).sum())
    for r in results:
        assert (r["world"], r["backend"], r["shards"]) == (2, "gloo", 4)
        with np.load(r["counts_file"]) as z:
            keys, counts = z["keys"], z["counts"]
        assert dict(zip(keys.tolist(), counts.tolist())) == serial
        assert np.array_equal(keys, jk) and np.array_equal(counts, jc)
        assert np.array_equal(keys, one[0]) and np.array_equal(counts, one[1])
        assert r["total"] == jt == one[2] == expected_total
        assert r["count_bytes_sent"] > 0 and r["kmer_bytes_sent"] > 0
        assert r["kmer_matches_counter"] is True and r["kmer_bins_covered"] > 0

    # bins: rank r holds shards 4r..4r+3 of eight, as JAX's psum_scatter leaves them
    codes = kmer._concat_codes(seqs)
    words, bad, chunk = distgraph.kmer_rows(codes, kk, 8)
    one_shards = distgraph.make_distributed_kmer_step(["cpu"] * 8, kk, chunk)(words, bad)
    jax_table = np.asarray(jax_distgraph.distributed_kmer_count(codes, kk, jax.devices()[:8]))
    _Tp, B = distgraph.kmer_layout(kk, 8)
    for r in results:
        for (lo, hi), digest in zip(r["kmer_bins"], r["kmer_digests"]):
            g = lo // B
            assert (lo, hi) == (g * B, (g + 1) * B) and g // 4 == r["rank"]
            assert digest == multiproc.bins_digest(one_shards[g], lo)
            jax_bins = np.zeros(B, np.int32)
            part = jax_table[lo:hi].astype(np.int32)
            jax_bins[: len(part)] = part
            assert digest == multiproc.bins_digest(torch.from_numpy(jax_bins), lo)


@pytest.mark.parametrize("counter", ["sorted", "dense", "host"])
def test_counter_range_from_every_counter(counter, monkeypatch):
    monkeypatch.setattr(kmer, "counter_for", lambda device_type, n_codes: counter)
    _, (seqs, kk) = multiproc.dcn_inputs()
    ref = jax_kmer.KmerCounter.from_sequences(seqs, kk)
    bins = np.zeros(4**kk + 8, np.int32)
    bins[ref.kmers.astype(np.int64)] = ref.counts
    nonzero = 0
    for lo, hi in [(0, 4096), (5000, 9000), (4**kk - 100, 4**kk + 8)]:
        got = multiproc._counter_range(seqs, kk, "cpu", lo, hi)
        assert got.dtype == torch.int32 and got.shape == (hi - lo,)
        assert np.array_equal(got.numpy(), bins[lo:hi])
        nonzero += int((got != 0).sum())
    assert nonzero > 0


def test_nccl_with_ranks_on_one_device_raises(tmp_path):
    with pytest.raises(ValueError, match="card of its own"):
        multiproc.run_workers(str(tmp_path), "nccl", ["cuda:0", "cuda:0"])
    with pytest.raises(ValueError, match="CUDA device"):
        multiproc.check_backend("nccl", ["cpu", "cpu"])
    with pytest.raises(ValueError, match="unsupported backend"):
        multiproc.check_backend("mpi", ["cpu", "cpu"])
    multiproc.check_backend("gloo", ["cuda:0", "cuda:0"])
    multiproc.check_backend("nccl", ["cuda:0", "cuda:1"])
