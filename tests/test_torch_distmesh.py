"""The port's mesh families (`amira_tpu_torch.parallel.mesh`, `distgraph`)
against the JAX package's `amira_tpu/parallel/distgraph.py` on the CPU.

* The full graph build on ("data", "table") 2 x 2 and ("host", "data",
  "table") 2 x 2 x 2 meshes of CPU shards equals JAX's on meshes of the
  same shape from the 8 CPU devices of tests/conftest.py, on the read sets of
  tests/test_torch_distgraph.py (past 16k nodes and k = 5 with short reads
  among them).
* The count-only steps on ("data",), ("data", "table") and ("host",
  "data", "table") meshes equal JAX's: arrays, dtypes, lengths, partition
  order and total, with a capacity above and one below the number of
  unique keys, on reads whose hashes include keys of 2^63 and above, with
  T = 3 (where unsigned and signed remainders differ) and with rows
  skewed so that the route drops entries.
* `bounded_count`, `_route_table` and `local_genemer_tables` equal JAX's
  on keys of 2^63 and above, and `scaling_report` gives rows of JAX's
  shape.

Tolerance: zero; every comparison is exact.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from amira_tpu.parallel import distgraph as jax_distgraph
from amira_tpu.vocab import GeneVocab as JaxVocab
from amira_tpu_torch.parallel import distgraph
from amira_tpu_torch.parallel.mesh import Mesh
from amira_tpu_torch.vocab import GeneVocab
from test_torch_distgraph import CASES, _graph_state, _random_reads

FAMILIES = {
    "data_table_2x2": ((2, 2), ("data", "table")),
    "host_data_table_2x2x2": ((2, 2, 2), ("host", "data", "table")),
}


def _meshes(shape, axes):
    n = int(np.prod(shape))
    jax_mesh = JaxMesh(np.array(jax.devices()[:n]).reshape(shape), axes)
    port_mesh = Mesh(np.array(["cpu"] * n, dtype=object).reshape(shape), axes)
    return jax_mesh, port_mesh


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("case", list(CASES))
def test_table_mesh_graph_build_equals_jax(case, family):
    k, kwargs = CASES[case]
    reads, positions = _random_reads(**kwargs)
    jax_mesh, port_mesh = _meshes(*FAMILIES[family])
    ref = jax_distgraph.distributed_graph_build(
        dict(reads), k, jax_mesh, vocab=JaxVocab(), gene_positions=positions
    )
    got = distgraph.distributed_graph_build(
        dict(reads), k, port_mesh, vocab=GeneVocab(), gene_positions=positions
    )
    want = _graph_state(ref)
    assert _graph_state(got) == want
    # the same graph as the one-axis build over as many shards
    flat = distgraph.distributed_graph_build(
        dict(reads), k, ["cpu"] * port_mesh.size, vocab=GeneVocab(), gene_positions=positions
    )
    assert _graph_state(flat) == want
    if case == "past_16k_nodes":
        assert len(want["nodes"]) > 1 << 14


def _count_inputs(seed, skewed):
    """(R, L) signed tokens and lengths; `skewed` makes three rows in four
    one repeated gene (one gene-mer), with rows enough that one partition's
    bucket overflows the route's capacity (past its floor of 128) when
    T >= 3."""
    rng = np.random.RandomState(seed)
    R, L = (512 if skewed else 64), 12
    tokens = (
        rng.randint(1, 30, size=(R, L)).astype(np.int32)
        * rng.choice([-1, 1], size=(R, L)).astype(np.int32)
    )
    lengths = rng.randint(3, L + 1, size=(R,)).astype(np.int32)
    if skewed:
        rows = np.arange(R) % 4 != 0
        tokens[rows] = 7
        lengths[rows] = L
    return tokens, lengths


# name: (mesh shape, axes, host entry)
COUNT_MESHES = {
    "data_1": ((1,), ("data",), "distributed_node_counts"),
    "data_2": ((2,), ("data",), "distributed_node_counts"),
    "data_8": ((8,), ("data",), "distributed_node_counts"),
    "data_table_4x2": ((4, 2), ("data", "table"), "distributed_node_counts_2d"),
    "data_table_2x3": ((2, 3), ("data", "table"), "distributed_node_counts_2d"),
    "data_table_2x4": ((2, 4), ("data", "table"), "distributed_node_counts_2d"),
    "host_data_table_2x2x2": ((2, 2, 2), ("host", "data", "table"), "distributed_node_counts_3d"),
    "host_data_table_2x1x4": ((2, 1, 4), ("host", "data", "table"), "distributed_node_counts_3d"),
}


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("capacity", [1 << 10, 48])
@pytest.mark.parametrize("name", list(COUNT_MESHES))
def test_count_steps_equal_jax(name, capacity, skewed):
    shape, axes, entry = COUNT_MESHES[name]
    tokens, lengths = _count_inputs(3, skewed)
    jax_mesh, port_mesh = _meshes(shape, axes)
    rk, rc, rt = getattr(jax_distgraph, entry)(tokens, lengths, 3, jax_mesh, capacity)
    gk, gc, gt = getattr(distgraph, entry)(tokens, lengths, 3, port_mesh, capacity)
    assert (gk.dtype, gc.dtype) == (np.uint64, np.int32) == (rk.dtype, rc.dtype)
    assert np.array_equal(gk, rk) and np.array_equal(gc, rc)
    assert gt == rt and isinstance(gt, int)
    all_keys = np.asarray(jax_distgraph.local_genemer_tables(tokens, lengths, 3, 1 << 12)[0])
    assert (all_keys >= np.uint64(1 << 63)).any()  # unsigned order decides the cut
    if capacity == 48:
        assert int((all_keys != 0).sum()) > capacity  # the capacity cut keys
    else:
        assert (rk >= np.uint64(1 << 63)).any()
    valid = int(np.maximum(lengths - 2, 0).sum())
    if skewed and axes[-1] == "table" and shape[-1] >= 3 and capacity > 48:
        assert rt < valid  # the route dropped entries, as JAX's does
    if axes == ("data",):
        assert rt == valid and len(gk) == capacity


@pytest.mark.parametrize("capacity", [4000, 100])
def test_bounded_count_equals_jax_on_high_keys(capacity):
    rng = np.random.RandomState(1)
    n = 3000
    pool = rng.randint(1, 1 << 62, size=400, dtype=np.int64).astype(np.uint64)
    pool[::2] |= np.uint64(1 << 63)
    keys = pool[rng.randint(0, len(pool), size=n)]
    keys[rng.rand(n) < 0.1] = 0
    weights = rng.randint(1, 9, size=n).astype(np.int32)
    rk, rc = (np.asarray(x) for x in jax_distgraph.bounded_count(keys, weights, capacity))
    gk, gc = distgraph.bounded_count(
        torch.from_numpy(keys.view(np.int64)), torch.from_numpy(weights), capacity
    )
    assert np.array_equal(gk.numpy().view(np.uint64), rk)
    assert gc.dtype == torch.int32 and np.array_equal(gc.numpy(), rc)


@pytest.mark.parametrize("T,send_cap", [(2, 40), (3, 40), (3, 400), (5, 17)])
def test_route_table_equals_jax(T, send_cap):
    rng = np.random.RandomState(T * 100 + send_cap)
    n = 300
    keys = rng.randint(1, 1 << 62, size=n, dtype=np.int64).astype(np.uint64)
    keys[::3] |= np.uint64(1 << 63)
    keys[rng.rand(n) < 0.1] = 0
    counts = rng.randint(1, 50, size=n).astype(np.int32)
    firsts = rng.permutation(n * 3)[:n].astype(np.uint64)
    ref = jax_distgraph._route_table(keys, counts, firsts, T, send_cap)
    got = distgraph._route_table(
        torch.from_numpy(keys.view(np.int64)), torch.from_numpy(counts),
        torch.from_numpy(firsts.view(np.int64)), T, send_cap,
    )
    assert np.array_equal(got[0].numpy().view(np.uint64), np.asarray(ref[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert np.array_equal(got[2].numpy().view(np.uint64), np.asarray(ref[2]))
    assert got[3] == int(ref[3])
    # the partition of a key at 2^63 and above follows its unsigned value
    live = np.asarray(ref[0]) != 0
    assert (np.asarray(ref[0])[live] >= np.uint64(1 << 63)).any()


@pytest.mark.parametrize("k,capacity", [(3, 1 << 12), (5, 1 << 12), (5, 64)])
def test_local_genemer_tables_equal_jax(k, capacity):
    tokens, lengths = _count_inputs(k, skewed=False)
    ref = jax_distgraph.local_genemer_tables(tokens, lengths, k, capacity)
    got = distgraph.local_genemer_tables(torch.from_numpy(tokens), torch.from_numpy(lengths),
                                         k, capacity)
    for i in (0, 2):
        assert np.array_equal(got[i].numpy().view(np.uint64), np.asarray(ref[i]))
    for i in (1, 3):
        assert np.array_equal(got[i].numpy(), np.asarray(ref[i]))


def test_scaling_report_rows_have_jax_shape():
    tokens, lengths = _count_inputs(1, skewed=False)
    tokens, lengths = tokens[:32], lengths[:32]
    ref = jax_distgraph.scaling_report(tokens, lengths, k=3, capacity=1 << 10, repeats=1)
    got = distgraph.scaling_report(tokens, lengths, k=3, capacity=1 << 10, repeats=1,
                                   devices=["cpu"] * len(jax.devices()))
    assert [(r["mesh"], r["n_devices"]) for r in got] == [
        (r["mesh"], r["n_devices"]) for r in ref
    ]
    assert [sorted(r) for r in got] == [sorted(r) for r in ref]
    assert got[0]["efficiency"] == 1.0
    assert all(r["reads_per_sec"] > 0 for r in got)


def test_mesh_axes_and_repeated_devices():
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], ("data", "table"))
    assert mesh.shape == {"data": 2, "table": 2} and mesh.size == 4
    assert [f for f, _ in mesh.local_shards()] == [0, 1, 2, 3]
    assert mesh.axis("host") == 1 and mesh.first_device == torch.device("cpu")
    with pytest.raises(ValueError):
        Mesh(["cpu", "cpu"], ("data", "table"))
