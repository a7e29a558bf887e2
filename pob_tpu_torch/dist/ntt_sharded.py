"""Distributed four-step NTT over a device mesh (the counterpart of
pob_tpu/dist/ntt_sharded.py): lets the Groth16 QAP domain exceed one card.

Decomposition: N = N1 * N2, input viewed row-major as A[n1, n2] sharded along
n2. Then
  X[k2*N1 + k1] = sum_{n2} w^{n2 k1} W_{N2}^{n2 k2} ( sum_{n1} A[n1,n2] W_{N1}^{n1 k1} )
so: (1) local NTT over the n1 columns, (2) local twiddle by w^{n2 k1},
(3) all_to_all transpose resharding k1, (4) local NTT over the n2 rows.
Output layout is the transposed matrix C[k1, k2] sharded along k1, as the
list of this process's row blocks (all D of them on a mesh that one process
drives); `untranspose_host` reorders it for verification.

There is no new kernel: the small transforms are K2 (``ntt.ntt`` /
``ntt.intt``, the columns first copied to contiguous rows), the twiddle is
K1, and the transpose is the mesh's all_to_all (copies, or
``all_to_all_single`` across processes).

Step 3 inserts the gathered axis at 1, so that row k1 of shard r holds the
n2 of source shard s at s * N2/D + b, in natural order. pob_tpu's body
inserts it at 2, which puts n2 = s * N2/D + b at b * D + s: the same order
only when N2/D = 1 (its tests: k1 = k2 = 3 on 8 devices). With k1 = k2 = 3
on 2 or 4 devices its result differs from the local NTT."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import limb
from ..field.limb import FR
from ..field.ref import FR_MOD
from ..prover import ntt
from .mesh import Mesh, all_to_all, local, on, shard

_R = (1 << 256) % FR_MOD


@functools.lru_cache(maxsize=None)
def _outer_twiddle(k1: int, k2: int, inverse: bool) -> np.ndarray:
    """w^{n2 * k1_idx} table of shape (N1, N2, 16) (Montgomery limbs, int32):
    pob_tpu's table, each row a running product instead of a pow per
    entry."""
    w = ntt.domain_root(k1 + k2)
    if inverse:
        w = pow(w, FR_MOD - 2, FR_MOD)
    n1, n2 = 1 << k1, 1 << k2
    vals = []
    for i in range(n1):
        step, acc = pow(w, i, FR_MOD), _R
        for _ in range(n2):
            vals.append(acc)
            acc = acc * step % FR_MOD
    return limb.ints_to_limbs(vals).reshape(n1, n2, limb.L)


def table_shards(mesh: Mesh, table: np.ndarray, dim: int) -> list:
    """A host table sharded over the mesh along `dim`."""
    return shard(mesh, torch.from_numpy(np.ascontiguousarray(table)), dim)


def four_step_local(mesh: Mesh, blocks: list, tws: list, k1: int, k2: int,
                    inverse: bool = False) -> list:
    """The four-step body over the mesh's shards.

    blocks: shard i's (N1, N2/D, 16) Montgomery limbs, for each shard i of
    this process: full columns for a slice of n2 of the matrix view A[n1,
    n2] of a natural-order vector x[n1*N2 + n2]. tws: the matching slices of
    _outer_twiddle(k1, k2, inverse). Returns this process's blocks (N1/D,
    N2, 16) of C[k1, k2] = X[k2*N1 + k1] sharded along k1. With
    inverse=True both small transforms are inverse NTTs (their 1/N1 and
    1/N2 factors compose to the full 1/N) and tws must be the inverse
    table."""
    ndev = len(mesh.devices)
    n1 = 1 << k1
    small = ntt.intt if inverse else ntt.ntt
    twiddled = []
    for _, dev, block, tw in local(mesh, blocks, tws):
        with on(dev):
            cols = small(block.movedim(0, -2).contiguous(), k1)  # step 1: over n1
            b = limb.mont_mul(FR, cols.movedim(-2, 0), tw)  # step 2: (N1, N2/D)
        twiddled.append(b.reshape(ndev, n1 // ndev, b.shape[1], limb.L))
    out = []
    for _, dev, b in local(mesh, all_to_all(mesh, twiddled, 0, 1)):  # step 3
        with on(dev):
            out.append(small(b.reshape(n1 // ndev, 1 << k2, limb.L), k2))  # step 4: over n2
    return out


def ntt_sharded(mesh: Mesh, a, k1: int, k2: int, inverse: bool = False) -> list:
    """a: (N1*N2, 16) Montgomery limbs, natural order (on a mesh across
    processes, every rank's a). Returns C of shape (N1, N2, 16) as this
    process's blocks of its D blocks (N1/D, N2, 16) along axis 0, with
    X[k2*N1 + k1] = C[k1, k2]. inverse=True computes the inverse transform
    (including the 1/n scale). The twiddle table is sharded per call (the
    host table is made once); the sharded prove keeps its tables on its
    ShardedProvingKey."""
    n1, n2 = 1 << k1, 1 << k2
    ndev = len(mesh.devices)
    if n1 % ndev or n2 % ndev:
        raise ValueError(f"2^{k1} x 2^{k2} does not split over {ndev} devices")
    blocks = shard(mesh, a.reshape(n1, n2, limb.L), dim=1)
    tws = table_shards(mesh, _outer_twiddle(k1, k2, inverse), 1)
    return four_step_local(mesh, blocks, tws, k1, k2, inverse)


def untranspose_host(c) -> np.ndarray:
    """C[k1, k2] (an array, or the list of all its row blocks: on a mesh
    across processes, gather them first) -> X[k2*N1 + k1] on the host
    (verification helper)."""
    if isinstance(c, list):
        c = torch.cat([b.cpu() for b in c])
    c = np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c)
    n1, n2 = c.shape[0], c.shape[1]
    return np.transpose(c, (1, 0, 2)).reshape(n1 * n2, limb.L)
