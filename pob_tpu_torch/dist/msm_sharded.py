"""MSM sharded over a device mesh (the counterpart of
pob_tpu/dist/msm_sharded.py).

Points and scalars are partitioned along the mesh axis: each shard runs K3
(``msm.msm_batched`` at B = 1, over the shard's own shifted bases, made by
K6 on its device) over its points. The D Jacobian partials (3 coordinates
each, one tensor per shard) are then gathered and reduced by a tree of
point adds whose field products and sums are K1 launches
(``curve.FqOpsK1``): point addition is not a sum over coordinates, so the
collective moves 3 coordinates per shard, next to nothing beside the local
work. On a mesh across processes the gather is an all-gather and every rank
reduces its own copy, as pob_tpu's shards do, so every rank returns the
same point; on a mesh that one process drives the partials are copied to
the mesh's first device and reduced there once, since one reduced copy is
all the caller reads.

pob_tpu's body sends a shard of fewer than 4,096 points to its bitwise
double-and-add MSM; the port sends every size to K3."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field import limb
from ..prover import curve, msm
from .mesh import Mesh, gather, local, on, shard


@dataclass
class ShardedPoints:
    """A point query split over a mesh: per shard of this process, its
    Jacobian points (mp / D,) on its device and, on the card, their K3 bases
    (``msm.affine_bases``; None on the CPU, whose plain MSM adds Jacobian
    points); m the true count, mp the count padded with infinity."""

    group: str
    shards: list
    bases: list | None
    m: int
    mp: int


def _group(points) -> str:
    """The points' group, "g1" or "g2", from the rank of their coordinates
    (G2's are (..., 2, 16))."""
    if isinstance(points, ShardedPoints):
        return points.group
    return "g1" if points[0].dim() == 2 else "g2"


def _pad_shard_points(points, mesh: Mesh, perm=None,
                      windows: int = msm.N_WINDOWS) -> ShardedPoints:
    """pob_tpu's prove_sharded._pad_shard_points (here, where the sharded MSM
    and the pipeline use it too): gather a Jacobian batch through `perm` if
    given, pad it to a multiple of the mesh size with infinity (Z = 0) and
    split it over the mesh, with the K3 bases of this process's shards
    (`windows` shifted windows each) made by K6 on their cards."""
    ndev = len(mesh.devices)
    group = _group(points)
    m = int(points[0].shape[0])
    if perm is not None:
        idx = torch.as_tensor(perm, device=points[0].device)
        points = tuple(c[idx] for c in points)
    mp = -(-max(m, 1) // ndev) * ndev
    if mp != m:
        inf = curve.infinity(curve.ops_for(group), (mp - m,), points[0].device)
        points = tuple(torch.cat([c, i], 0) for c, i in zip(points, inf))
    per_coord = [shard(mesh, c) for c in points]
    shards = list(zip(*per_coord))
    bases = None
    if mesh.devices[0].type == "cuda":
        bases = []
        for _, dev, pts in local(mesh, shards):
            with on(dev):
                bases.append(msm.affine_bases(group, pts, windows))
    return ShardedPoints(group, shards, bases, m, mp)


def _pad_scalars(sc, mp: int):
    m = int(sc.shape[0])
    if m == mp:
        return sc
    return torch.cat([sc, sc.new_zeros((mp - m, limb.L))], 0)


def msm_sharded(mesh: Mesh, points, scalars):
    """points: a ShardedPoints, or Jacobian tensors with leading axis m
    (sharded here, bases included), G1 or G2 by their shape; scalars: (m,
    16) canonical limbs, or the list of this process's shards. Returns one
    Jacobian point: on the mesh's first device for a mesh that one process
    drives, on its own device on every rank of a mesh across processes."""
    group = _group(points)
    if not isinstance(points, ShardedPoints):
        points = _pad_shard_points(points, mesh)
    if not isinstance(scalars, list):
        scalars = _pad_scalars(scalars, points.mp)
    sc = shard(mesh, scalars)
    bases = points.bases or [None] * len(sc)
    partials = []
    for _, dev, pts, s, b in local(mesh, points.shards, sc, bases):
        with on(dev):
            p = msm.msm_batched(group, pts, s[None], b)
            partials.append(torch.stack([c[0] for c in p]))  # (3, ...): X, Y, Z
    stacked = gather(mesh, partials)  # (D, 3, ...)
    with on(stacked.device):
        coords = tuple(c.contiguous() for c in stacked.unbind(1))
        return curve.tree_reduce(curve.k1_ops_for(group), coords)


def _of_group(group: str, points):
    if _group(points) != group:
        raise ValueError(f"msm_{group}_sharded takes {group.upper()} points")
    return points


def msm_g1_sharded(mesh, points, scalars):
    return msm_sharded(mesh, _of_group("g1", points), scalars)


def msm_g2_sharded(mesh, points, scalars):
    return msm_sharded(mesh, _of_group("g2", points), scalars)
