"""Device meshes and their two collectives (the counterpart of
pob_tpu/dist/mesh.py).

pob_tpu's dist layer is single-controller: one process holds a
``jax.sharding.Mesh`` and ``shard_map`` runs a body per shard. Here one
process holds a ``Mesh``, an ordered tuple of torch devices with an axis
name, and a sharded array is the list of its shards in mesh order, shard i
on ``mesh.devices[i]``. A mesh may repeat a device (``data_mesh(n,
device=...)``): a virtual mesh on one card, or on the CPU in the tests, as
pob_tpu's tests get 8 virtual CPU devices from XLA.

The collectives are explicit copies between the shards' devices, a peer
copy between two cards and a device copy on one. Every receiver gets a
tensor of its own, even from a shard on its own device, so no shard of a
virtual mesh can write into another's data. Each device's work runs on that
device's current stream (the pipeline picks one per stage); a copy between
two cards waits for the source stream's work and the destination stream
waits for the copy (PyTorch records and waits on an event on each side).
The kernels are launched through ctypes on the current device, so each
shard's work runs under ``on(its device)``.

pob_tpu's ``shard_map_norep`` has no counterpart: there is no replication
checker to silence. ``init_multihost`` (a mesh across processes) is not
ported yet."""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from .. import _build


def _concrete(device) -> torch.device:
    """torch.device with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one named axis."""

    devices: tuple
    axis: str = "data"

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(_concrete(d) for d in self.devices))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")


def data_mesh(n_devices: int | None = None, axis: str = "data", device=None) -> Mesh:
    """The first n_devices visible cards (all of them by default); raises
    when fewer are visible. With `device`, n_devices (default 1) copies of
    that one device: a virtual mesh."""
    if device is not None:
        dev = _concrete(_build.resolve_device(device))
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"a mesh needs at least one device, got {n}")
        return Mesh((dev,) * n, axis)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    if n < 1 or n > have:
        raise RuntimeError(f"data_mesh needs {n} CUDA devices and {have} are visible; pass "
                           "device=... for a virtual mesh of one device")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), axis)


def on(device):
    """Context in which a shard's kernels launch on its card (nothing on the
    CPU)."""
    device = torch.device(device)
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def send(t: torch.Tensor, device) -> torch.Tensor:
    """A copy of t on `device`: a new tensor even where t lies there."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _check_shards(mesh: Mesh, parts):
    if len(parts) != len(mesh.devices):
        raise ValueError(f"{len(parts)} shards for a mesh of {len(mesh.devices)}")
    for p, dev in zip(parts, mesh.devices):
        if p.device != dev:
            raise ValueError(f"a shard lies on {p.device}, its mesh device is {dev}")


def shard(mesh: Mesh, x, dim: int = 0) -> list:
    """x split into len(mesh.devices) equal blocks along `dim`, block i
    copied to mesh.devices[i]; a list (already sharded) is returned as it
    is."""
    if isinstance(x, list):
        _check_shards(mesh, x)
        return x
    n = len(mesh.devices)
    if x.shape[dim] % n:
        raise ValueError(f"axis of size {x.shape[dim]} does not split over {n} devices")
    return [send(b, dev) for b, dev in zip(x.chunk(n, dim), mesh.devices)]


def gather(mesh: Mesh, parts: list, dst: int = 0) -> torch.Tensor:
    """The (D, ...) stack of one tensor per shard, on mesh.devices[dst]."""
    _check_shards(mesh, parts)
    g = torch.empty((len(parts),) + tuple(parts[0].shape), dtype=parts[0].dtype,
                    device=mesh.devices[dst])
    for j, p in enumerate(parts):
        g[j].copy_(p)
    return g


def all_gather(mesh: Mesh, parts: list) -> list:
    """jax.lax.all_gather of one tensor per shard: every shard i gets the
    (D, ...) stack of all D parts on mesh.devices[i]."""
    return [gather(mesh, parts, i) for i in range(len(mesh.devices))]


def all_to_all(mesh: Mesh, blocks: list, split_axis: int, concat_axis: int) -> list:
    """jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=False) over
    the mesh: every block has size D along split_axis; shard r gets slice r
    of every block, stacked in shard order as a new axis at concat_axis of
    the slice's shape."""
    _check_shards(mesh, blocks)
    n = len(mesh.devices)
    if any(b.shape[split_axis] != n for b in blocks):
        raise ValueError(f"split axis must have size {n}")
    out = []
    for r, dev in enumerate(mesh.devices):
        pieces = [b.select(split_axis, r) for b in blocks]
        shape = list(pieces[0].shape)
        shape.insert(concat_axis, n)
        o = torch.empty(shape, dtype=pieces[0].dtype, device=dev)
        for s, p in enumerate(pieces):
            o.select(concat_axis, s).copy_(p)
        out.append(o)
    return out
