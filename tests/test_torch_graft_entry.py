"""The port's entry points (`amira_tpu_torch.graft_entry`), the twin of
`__graft_entry__.py`, on CPU shards.

`entry("cpu")`'s function on its example batch equals the JAX entry's
function on the same batch (node and edge tables, exactly), and
`dryrun_multichip` passes its three checks at 2, 4 and 8 shards: the
("data",), ("data", "table") and ("host", "data", "table") families that
the JAX dry run picks for those counts. With device=None both ask for the
card and raise without CUDA.

Tolerance: zero; every comparison is exact.
"""

import os
import sys

import numpy as np
import pytest
import torch

from amira_tpu_torch import graft_entry


def test_entry_equals_jax_entry():
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import __graft_entry__ as jax_entry

    fn, args = graft_entry.entry("cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args)
    jfn, jargs = jax_entry.entry()
    assert all(np.array_equal(a.numpy(), j) for a, j in zip(args, jargs))
    ref = [np.asarray(x) for x in jfn(*jargs)]
    for i in (0, 2):
        assert np.array_equal(got[i].numpy().view(np.uint64), ref[i])
    for i in (1, 3):
        assert np.array_equal(got[i].numpy(), ref[i])
    assert all(int((o != 0).sum()) > 0 for o in got)


@pytest.mark.parametrize(
    "n,mesh",
    [(2, "2 (data)"), (4, "2x2 (data x table)"), (8, "2x2x2 (host x data x table)")],
)
def test_dryrun_multichip_on_cpu_shards(n, mesh, capsys):
    out = graft_entry.dryrun_multichip(n, device="cpu")
    assert out["mesh"] == mesh
    assert out["nodes"] > 0 and out["kmers"] > 0 and out["unique_nodes"] > 0
    assert "dryrun_multichip OK" in capsys.readouterr().out


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(2)
    assert graft_entry.mesh_devices(3, "cpu") == [torch.device("cpu")] * 3
