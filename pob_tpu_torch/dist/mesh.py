"""Device meshes, their collectives and the process group (the counterpart
of pob_tpu/dist/mesh.py).

pob_tpu's dist layer is single-controller: one process holds a
``jax.sharding.Mesh`` and ``shard_map`` runs a body per shard; after
``init_multihost`` (``jax.distributed.initialize``) the same mesh spans
every process and each runs the bodies of its own devices. Here a ``Mesh``
is an ordered tuple of torch devices with an axis name, and a sharded array
is the list of the shards this process owns, in mesh order. Every body
loops over ``local(mesh, ...)``, which yields those shards with their index
and device.

Two kinds of mesh:

- **One process** (``rank`` None): every shard is local, shard i on
  ``mesh.devices[i]``. A mesh may repeat a device (``data_mesh(n,
  device=...)``): a virtual mesh on one card, or on the CPU in the tests,
  as pob_tpu's tests get 8 virtual CPU devices from XLA. The collectives
  are explicit copies between the shards' devices, a peer copy between two
  cards and a device copy on one. Every receiver gets a tensor of its own,
  even from a shard on its own device, so no shard of a virtual mesh can
  write into another's data. A copy between two cards waits for the source
  stream's work and the destination stream waits for the copy (PyTorch
  records and waits on an event on each side).
- **Across processes** (``data_mesh()`` after ``init_multihost``): one rank
  per process, one shard per rank, shard i on rank i of the default process
  group (NCCL on the cards, gloo on the CPU); ``rank`` is this process's,
  and ``devices`` every rank's device. The collectives go through
  ``torch.distributed`` on contiguous buffers. An NCCL collective runs on
  the communicator's stream after the current stream's work, and the
  current stream waits for it.

The kernels are launched through ctypes on the current device, so each
shard's work runs under ``on(its device)``. pob_tpu's ``shard_map_norep``
has no counterpart: there is no replication checker to silence."""

from __future__ import annotations

import contextlib
import os
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .. import _build
from ..field import limb


def _concrete(device) -> torch.device:
    """torch.device with its index: "cuda" is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


@dataclass(frozen=True)
class Mesh:
    """An ordered tuple of devices along one named axis. `rank` is None for
    a mesh that one process drives; on a mesh across processes it is this
    process's rank, which owns shard `rank` (and only that shard)."""

    devices: tuple
    axis: str = "data"
    rank: int | None = None

    def __post_init__(self):
        object.__setattr__(self, "devices", tuple(_concrete(d) for d in self.devices))
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if self.rank is not None and not 0 <= self.rank < len(self.devices):
            raise ValueError(f"rank {self.rank} is outside a mesh of {len(self.devices)}")

    @property
    def local_ids(self) -> tuple:
        """The mesh indices of the shards this process owns."""
        return tuple(range(len(self.devices))) if self.rank is None else (self.rank,)


def in_process_group() -> bool:
    """True once init_multihost (or any init_process_group) has run."""
    return dist.is_available() and dist.is_initialized()


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None, device=None, **kw):
    """Join the process group of a mesh across processes; pob_tpu's
    init_multihost, with jax.distributed.initialize replaced by
    torch.distributed.init_process_group over ``tcp://{coordinator}``.

    Arguments fall back to the launcher environment (POB_COORDINATOR /
    POB_NUM_PROCESSES / POB_PROCESS_ID) exactly as pob_tpu's do, so a job
    can be started as
        POB_COORDINATOR=host0:1234 POB_NUM_PROCESSES=4 POB_PROCESS_ID=$i ...
    in each process. No-op (None) when no coordinator is configured.

    On the card (the default) the backend is NCCL and this process's card,
    made current, is `device`'s index if it has one, else LOCAL_RANK when set
    (torchrun), else process_id modulo the visible cards; with
    device="cpu" the backend is gloo. With no card and no CPU request it
    raises, as every entry point does. `kw` goes to init_process_group
    (`timeout`, a datetime.timedelta). Returns pob_tpu's description of the
    process group."""
    coordinator = coordinator or os.environ.get("POB_COORDINATOR")
    if coordinator is None:
        return None
    if num_processes is None and os.environ.get("POB_NUM_PROCESSES"):
        num_processes = int(os.environ["POB_NUM_PROCESSES"])
    if process_id is None and os.environ.get("POB_PROCESS_ID"):
        process_id = int(os.environ["POB_PROCESS_ID"])
    dev = _build.resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda":
        backend = "nccl"
        index = dev.index
        if index is None:
            local_rank = os.environ.get("LOCAL_RANK")
            index = (int(local_rank) if local_rank is not None
                     else process_id % torch.cuda.device_count())
        torch.cuda.set_device(index)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id, **kw)
    return {
        "coordinator": coordinator,
        "num_processes": num_processes,
        "process_id": process_id,
        "process_index": dist.get_rank(),
        "global_devices": dist.get_world_size(),
        "local_devices": 1,
    }


def data_mesh(n_devices: int | None = None, axis: str = "data", device=None) -> Mesh:
    """With `device`, n_devices (default 1) copies of that one device: a
    virtual mesh. Otherwise, once the process group is up (init_multihost),
    the mesh across processes over the whole world (n_devices, if given,
    must be the world size): pob_tpu's data_mesh over the global
    jax.devices(). Otherwise the first n_devices visible cards (all of them
    by default); raises when fewer are visible."""
    if device is not None:
        dev = _concrete(_build.resolve_device(device))
        n = 1 if n_devices is None else n_devices
        if n < 1:
            raise ValueError(f"a mesh needs at least one device, got {n}")
        return Mesh((dev,) * n, axis)
    if in_process_group():
        world = dist.get_world_size()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"a mesh across processes spans the whole world of {world} "
                             f"ranks, not {n_devices}")
        mine = _concrete("cuda") if dist.get_backend() == "nccl" else torch.device("cpu")
        devices = [None] * world
        dist.all_gather_object(devices, str(mine))
        return Mesh(tuple(devices), axis, dist.get_rank())
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
    ids = mesh.local_ids
    if len(parts) != len(ids):
        raise ValueError(f"{len(parts)} shards where this process owns {len(ids)} of a mesh "
                         f"of {len(mesh.devices)}")
    for p, i in zip(parts, ids):
        if p.device != mesh.devices[i]:
            raise ValueError(f"a shard lies on {p.device}, its mesh device is {mesh.devices[i]}")


def local(mesh: Mesh, *parts):
    """(index, device, *shards) for each shard this process owns: each list
    in `parts` is a sharded array (this process's shards, in mesh order)."""
    ids = mesh.local_ids
    for p in parts:
        if len(p) != len(ids):
            raise ValueError(f"{len(p)} shards where this process owns {len(ids)}")
    for j, i in enumerate(ids):
        yield (i, mesh.devices[i], *(p[j] for p in parts))


def shard(mesh: Mesh, x, dim: int = 0) -> list:
    """x split into len(mesh.devices) equal blocks along `dim`, and the
    blocks of this process's shards copied to their devices (on a mesh
    across processes every rank holds x whole and keeps its own block); a
    list (already sharded) is returned as it is."""
    if isinstance(x, list):
        _check_shards(mesh, x)
        return x
    n = len(mesh.devices)
    if x.shape[dim] % n:
        raise ValueError(f"axis of size {x.shape[dim]} does not split over {n} devices")
    blocks = x.chunk(n, dim)
    return [send(blocks[i], mesh.devices[i]) for i in mesh.local_ids]


def _all_gather_stack(mesh: Mesh, p: torch.Tensor) -> torch.Tensor:
    """The (D, ...) stack of every rank's `p`, on this rank's device."""
    # all_gather_single where torch has it; before, all_gather_into_tensor
    gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    with on(p.device):
        out = torch.empty((len(mesh.devices),) + tuple(p.shape), dtype=p.dtype,
                          device=p.device)
        gather_into(out, p.contiguous()[None])
    return out


def gather(mesh: Mesh, parts: list, dst: int = 0) -> torch.Tensor:
    """The (D, ...) stack of one tensor per shard: on mesh.devices[dst] for a
    mesh that one process drives; on a mesh across processes an all-gather,
    which every rank calls and gets on its own device."""
    _check_shards(mesh, parts)
    if mesh.rank is not None:
        return _all_gather_stack(mesh, parts[0])
    g = torch.empty((len(parts),) + tuple(parts[0].shape), dtype=parts[0].dtype,
                    device=mesh.devices[dst])
    for j, p in enumerate(parts):
        g[j].copy_(p)
    return g


def all_gather(mesh: Mesh, parts: list) -> list:
    """jax.lax.all_gather of one tensor per shard: every shard i of this
    process gets the (D, ...) stack of all D parts on mesh.devices[i]."""
    return [gather(mesh, parts, i) for i in mesh.local_ids]


def all_to_all(mesh: Mesh, blocks: list, split_axis: int, concat_axis: int) -> list:
    """jax.lax.all_to_all(x, axis, split_axis, concat_axis, tiled=False) over
    the mesh: every block has size D along split_axis; shard r gets slice r
    of every block, stacked in shard order as a new axis at concat_axis of
    the slice's shape."""
    _check_shards(mesh, blocks)
    n = len(mesh.devices)
    if any(b.shape[split_axis] != n for b in blocks):
        raise ValueError(f"split axis must have size {n}")
    if mesh.rank is not None:
        b = blocks[0]
        with on(b.device):
            src = b.movedim(split_axis, 0).contiguous()
            dst = torch.empty_like(src)
            dist.all_to_all_single(dst, src)  # dst[s] = slice `rank` of shard s's block
            return [dst.movedim(0, concat_axis).contiguous()]
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


def broadcast_ints(mesh: Mesh, values) -> list:
    """Rank 0's python ints (each below 2^256) on every rank of a mesh across
    processes, which every rank calls with as many values; on a mesh that
    one process drives, `values` as they are."""
    values = list(values)
    if mesh.rank is None:
        return values
    dev = mesh.devices[mesh.rank]
    with on(dev):
        t = limb.to_device(limb.ints_to_limbs(values), dev)
        dist.broadcast(t, 0)
    return limb.limb_rows_to_ints(t.cpu().numpy())
