"""Device meshes and their collectives for the port's distributed layer.

Counterpart of `jax.sharding.Mesh` and of the `jax.lax` collectives that
`amira_tpu/parallel/distgraph.py` calls (all_gather, all_to_all, psum,
psum_scatter). A mesh is an array of torch devices with axis names, one
shard per entry: ("data",), ("data", "table"), ("host", "data", "table")
or ("kdata",). A device may repeat, which is how one card, or the CPU,
holds several shards.

Inside one process a collective is a copy between the shards' devices:
the steps of `distgraph` gather each group's tables onto one device of the
group and reduce them there. With a `torch.distributed` process group the
mesh's first axis is split over the processes: process r holds entries
[r * n, (r + 1) * n) of that axis, n being the extent of the device array
it passes (1 for a "host" axis on the process boundary). The three
collectives across processes are below; they run on the CPU for "gloo"
(tables are copied to the host explicitly) and on the rank's card for
"nccl", and they count the bytes that each process sends to the others.
"""

from __future__ import annotations

import numpy as np
import torch

# bytes this process has sent to other processes through the functions below
CROSS_PROCESS_BYTES = [0]

# elements per all_to_all of `reduce_scatter_processes` (bounds its buffers)
_EXCHANGE_CHUNK = 1 << 26


class Mesh:
    """An array of torch devices with named axes.

    devices: nested sequence (or array) of devices or device names, one
    dimension per axis. group: a `torch.distributed` process group over
    which the first axis is split (None for a mesh of one process)."""

    def __init__(self, devices, axis_names, group=None):
        arr = np.array(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"Mesh: {arr.ndim}-d devices for axes {self.axis_names}")
        self.devices = np.vectorize(torch.device, otypes=[object])(arr)
        self.group = group
        if group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.world = dist.get_world_size(group)
        extents = list(self.devices.shape)
        extents[0] *= self.world
        self.shape = dict(zip(self.axis_names, extents))
        self.size = int(np.prod(extents))
        self.local_size = self.devices.size
        # global flat index of this process's first shard
        self.offset = self.rank * self.local_size

    def axis(self, name: str) -> int:
        """Extent of an axis, 1 for an axis the mesh lacks."""
        return self.shape.get(name, 1)

    def local_shards(self):
        """(global flat index, device) of this process's shards, in mesh
        (row-major) order."""
        return [(self.offset + i, d) for i, d in enumerate(self.devices.reshape(-1))]

    def device_of(self, flat: int) -> torch.device:
        """Device of the local shard with global flat index `flat`."""
        return self.devices.reshape(-1)[flat - self.offset]

    @property
    def first_device(self) -> torch.device:
        return self.devices.reshape(-1)[0]


def as_mesh(mesh_or_devices) -> Mesh:
    """A Mesh as given, or the ("data",) mesh of a sequence of devices."""
    if isinstance(mesh_or_devices, Mesh):
        return mesh_or_devices
    devices = list(mesh_or_devices)
    if not devices:
        raise ValueError("no devices")
    return Mesh(devices, ("data",))


def gather(parts, device):
    """The parts concatenated on `device` in their order: all_gather over an
    axis inside one process."""
    return torch.cat([p.to(device) for p in parts])


def _comm_device(mesh):
    import torch.distributed as dist

    if dist.get_backend(mesh.group) == "nccl":
        return mesh.first_device
    return torch.device("cpu")


def all_gather_processes(mesh, tensor):
    """Every process's `tensor` (equal trailing shape, any length), in rank
    order, on `tensor`'s device: all_gather over the processes. Lengths are
    exchanged first, and each tensor is padded to the longest and cut back."""
    if mesh.group is None:
        return [tensor]
    import torch.distributed as dist

    dev = _comm_device(mesh)
    n = torch.tensor([tensor.shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.zeros_like(n) for _ in range(mesh.world)]
    dist.all_gather(sizes, n, group=mesh.group)
    sizes = [int(s) for s in sizes]
    buf = torch.zeros((max(sizes),) + tuple(tensor.shape[1:]), dtype=tensor.dtype, device=dev)
    buf[: tensor.shape[0]] = tensor.to(dev)
    outs = [torch.empty_like(buf) for _ in range(mesh.world)]
    dist.all_gather(outs, buf, group=mesh.group)
    CROSS_PROCESS_BYTES[0] += buf.numel() * buf.element_size() * (mesh.world - 1)
    return [o[:s].to(tensor.device) for o, s in zip(outs, sizes)]


def psum_processes(mesh, value) -> int:
    """`value` (an int or a one-element tensor) summed over the processes."""
    value = int(value)
    if mesh.group is None:
        return value
    import torch.distributed as dist

    t = torch.tensor([value], dtype=torch.int64, device=_comm_device(mesh))
    dist.all_reduce(t, group=mesh.group)
    CROSS_PROCESS_BYTES[0] += t.element_size() * (mesh.world - 1)
    return int(t)


def reduce_scatter_processes(mesh, partial):
    """psum_scatter over the processes: `partial` (N,), N a multiple of the
    process count, summed over the processes; process r keeps elements
    [r * N / P, (r + 1) * N / P), on `partial`'s device. The exchange is
    equal-split `all_to_all_single` calls of at most _EXCHANGE_CHUNK
    elements a process."""
    import torch.distributed as dist

    P, r = mesh.world, mesh.rank
    B = partial.shape[0] // P
    if B * P != partial.shape[0]:
        raise ValueError("reduce_scatter_processes: length not a multiple of the process count")
    out = partial[r * B : (r + 1) * B].clone()
    dev = _comm_device(mesh)
    for lo in range(0, B, _EXCHANGE_CHUNK):
        hi = min(lo + _EXCHANGE_CHUNK, B)
        send = torch.stack([partial[q * B + lo : q * B + hi] for q in range(P)]).to(dev)
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=mesh.group)
        CROSS_PROCESS_BYTES[0] += (hi - lo) * send.element_size() * (P - 1)
        recv[r] = 0  # this process's own part is already in `out`
        out[lo:hi] += recv.sum(dim=0, dtype=out.dtype).to(out.device)
    return out
