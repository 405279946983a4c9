"""Gene-mer hashing in torch int64 (`amira_tpu_torch.ops.hashing`,
`ops.graph_tables.pack_flat_windows`) is bit-identical to the JAX package's
uint64 versions (`amira_tpu.ops.hashing`, `ops.graph_tables`) and to its
NumPy host mirror (`ops.host_tables`), on fuzzed token streams that include
gene ids whose hash is at or above 2^62 and windows whose node hash is at or
above 2^63 (where signed and unsigned orders differ).

Tolerance: zero; hashes are compared as exact uint64 bit patterns.
"""

import numpy as np
import pytest
import torch

from amira_tpu.ops import graph_tables as jax_tables
from amira_tpu.ops import hashing as jax_hashing
from amira_tpu.ops.graph_tables import join_u64
from amira_tpu.ops.host_tables import _gene_hash, host_windows_edges
from amira_tpu_torch.ops import graph_tables, hashing


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _high_hash_ids(n):
    """Gene ids whose 63-bit gene hash is >= 2^62."""
    ids = np.arange(1, 20000, dtype=np.int64)
    h = _gene_hash(ids)
    big = ids[h >= (1 << 62)]
    assert len(big) >= n
    return big[:n]


def _fuzz_tokens(seed, R, L):
    rng = np.random.RandomState(seed)
    pool = np.concatenate([np.arange(1, 40), _high_hash_ids(40)])
    toks = rng.choice(pool, size=(R, L)) * rng.choice([-1, 1], size=(R, L))
    lengths = rng.randint(1, L + 1, size=R).astype(np.int32)
    for r in range(R):
        toks[r, lengths[r]:] = 0
    return toks.astype(np.int32), lengths


def test_splitmix_and_gene_hash_bit_identical():
    rng = np.random.RandomState(0)
    x = rng.randint(0, 2**63 - 1, size=4096, dtype=np.int64).astype(np.uint64)
    x[:4] = [0, 1, (1 << 63), (1 << 64) - 1]
    ref = np.asarray(jax_hashing.splitmix64(x))
    got = _u64(hashing.splitmix64(torch.from_numpy(x.view(np.int64))))
    np.testing.assert_array_equal(got, ref)
    toks = np.concatenate(
        [np.arange(-300, 301), _high_hash_ids(20), -_high_hash_ids(20)]
    ).astype(np.int32)
    ref = np.asarray(jax_hashing.gene_hash(toks))
    got = hashing.gene_hash(torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got >= (1 << 62)).any() and (got <= -(1 << 62)).any()


@pytest.mark.parametrize("k", [3, 5, 7])
def test_genemer_windows_and_edge_keys_bit_identical(k):
    toks, lengths = _fuzz_tokens(k, R=48, L=24)
    ref = jax_hashing.genemer_windows(toks, lengths, k)
    got = hashing.genemer_windows(torch.from_numpy(toks), torch.from_numpy(lengths), k)
    nh_ref = np.asarray(ref["node_hash"])
    np.testing.assert_array_equal(_u64(got["node_hash"]), nh_ref)
    np.testing.assert_array_equal(got["direction"].numpy(), np.asarray(ref["direction"]))
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(ref["valid"]))
    assert (nh_ref >= np.uint64(1 << 63)).any()  # unsigned order exercised
    # edge keys over adjacent windows, both the record and its rc companion
    src_h, tgt_h = nh_ref[:, :-1], nh_ref[:, 1:]
    d = np.asarray(ref["direction"])
    src_d, tgt_d = d[:, :-1], d[:, 1:]
    for a, ad, b, bd in ((src_h, src_d, tgt_h, tgt_d), (tgt_h, -tgt_d, src_h, -src_d)):
        e_ref = np.asarray(jax_hashing.edge_key(a, ad, b, bd))
        e_got = hashing.edge_key(
            torch.from_numpy(a.view(np.int64).copy()), torch.from_numpy(ad.copy()),
            torch.from_numpy(b.view(np.int64).copy()), torch.from_numpy(bd.copy()),
        )
        np.testing.assert_array_equal(_u64(e_got), e_ref)


@pytest.mark.parametrize("k", [3, 5, 7])
def test_pack_flat_windows_bit_identical(k):
    toks, lengths = _fuzz_tokens(100 + k, R=64, L=20)
    tok_list = [toks[r, : lengths[r]] for r in range(64) if lengths[r] >= k]
    flat = np.concatenate(tok_list).astype(np.int32)
    N = len(flat)
    buf = np.asarray(jax_tables.pack_flat_windows(flat, k))
    ref_h = join_u64(buf[:N], buf[N : 2 * N])
    ref_d = buf[2 * N :].astype(np.int8) - 1
    before = graph_tables.DEVICE_RUNS["cpu"]
    h, d = graph_tables.pack_flat_windows(torch.from_numpy(flat), k)
    assert graph_tables.DEVICE_RUNS["cpu"] == before + 1
    np.testing.assert_array_equal(_u64(h), ref_h)
    np.testing.assert_array_equal(d.numpy(), ref_d)
    # each read's valid windows equal the host mirror's
    host = host_windows_edges(tok_list, k)
    o = 0
    for tok, (wh, wd, _ek) in zip(tok_list, host):
        W = len(tok) - (k - 1)
        np.testing.assert_array_equal(_u64(h[o : o + W]), wh)
        np.testing.assert_array_equal(d[o : o + W].numpy(), wd)
        o += len(tok)



@pytest.mark.parametrize("k", [1, 3, 7])
def test_combine_hash_seq_bit_identical(k):
    toks, _ = _fuzz_tokens(200 + k, R=32, L=k)
    seq = np.asarray(jax_hashing.gene_hash(toks))  # (32, k) signed, |h| up to 2^63
    ref = np.asarray(jax_hashing._combine_hash_seq(seq))
    got = hashing._combine_hash_seq(torch.from_numpy(seq))
    np.testing.assert_array_equal(_u64(got), ref)


def test_node_hash_from_signed_seq_equals_jax():
    """JAX's own check (tests/test_graph_core.py:25-31) and its values: a
    gene-mer and its reverse complement share a hash, a changed strand
    does not, on tokens whose gene hash is at or above 2^62."""
    big = _high_hash_ids(4).astype(np.int32)
    seqs = [np.array([1, -2, 3], np.int32), np.array([-3, 2, -1], np.int32),
            np.array([1, -2, -3], np.int32), np.array([big[0], -big[1], big[2], 5, -big[3]])]
    got = [hashing.node_hash_from_signed_seq(s) for s in seqs]
    assert got == [jax_hashing.node_hash_from_signed_seq(s) for s in seqs]
    assert got[0] == got[1] != got[2]
    assert all(0 <= h < 1 << 64 for h in got)
