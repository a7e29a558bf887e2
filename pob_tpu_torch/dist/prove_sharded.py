"""Mesh-sharded Groth16 prove: ONE proof partitioned across a device mesh
(the counterpart of pob_tpu/dist/prove_sharded.py), for proofs whose
proving key / QAP domain exceed one card:

- the five MSM queries (a, b1, b2, l, h) are point-sharded along the mesh
  axis; each shard reduces its points with K3 over its own bases and the D
  Jacobian partials are gathered and combined by a tree reduction
  (dist/msm_sharded.py);
- the QAP h computation (inverse NTT, coset shift, forward NTT of each of
  A.w, B.w, C.w) runs as four-step transforms whose transpose is the mesh's
  all_to_all (dist/ntt_sharded.four_step_local), so no shard transforms a
  full 2^k-point polynomial. The two sparse mat-vecs run where the key's
  matrices lie, as pob_tpu's do.

Layout bookkeeping: the four-step returns the transposed matrix C[k1, k2] =
X[k2*N1 + k1] sharded along k1. Chaining inverse -> coset scale -> forward
needs no re-layout collective because (a) the coset scale is elementwise
(table in the transposed layout), and (b) the local transpose of the
k1-sharded block IS the column-sharded input the next four-step wants. The
final coset evals come out in the doubly-permuted order q -> (q % N1) * N2
+ q // N1; the h-query points go through that permutation once, in
shard_pk, so the MSM pairs scalars and points with no per-proof movement.

The sharded prove is pob_tpu's plain path: five K3 MSMs, no plan.

On a mesh across processes (``data_mesh()`` after ``init_multihost``)
every rank runs these functions on the same key, witness and arguments
(SPMD, as pob_tpu's processes run one program), holds the shards of its
own rank, and returns the same proof: ``shard_pk`` refuses a key that
differs between ranks, and ``prove_sharded`` takes rank 0's r and s."""

from __future__ import annotations

import functools
import hashlib
import secrets
from dataclasses import dataclass

import numpy as np
import torch

from ..field import limb
from ..field.limb import FR
from ..field.ref import FR_MOD
from ..prover import msm, ntt
from ..prover.groth16 import (MSM_QUERIES, ProvingKey, finish_proof, key_windows,
                              sparse_matvec_mont)
from .mesh import Mesh, broadcast_ints, gather, local, on, shard
from .msm_sharded import _pad_shard_points, msm_sharded
from .ntt_sharded import _outer_twiddle, four_step_local, table_shards

_R = (1 << 256) % FR_MOD


def _split_k(k: int, ndev: int) -> tuple[int, int]:
    """k = k1 + k2 with both 2^k1 and 2^k2 divisible by ndev."""
    d = max(0, (ndev - 1).bit_length())
    if k < 2 * d:
        raise ValueError(f"domain 2^{k} too small to 2D-decompose over {ndev} devices; "
                         f"need k >= {2 * d}")
    k1 = max((k + 1) // 2, d)
    return k1, k - k1


@functools.lru_cache(maxsize=None)
def _coset_table_transposed(k1: int, k2: int, shift: int) -> np.ndarray:
    """s^j * R in the transposed four-step layout: T[i1, i2] = s^{i2*N1+i1}."""
    n1, n2 = 1 << k1, 1 << k2
    pows, acc = [], 1
    for _ in range(n1 * n2):
        pows.append(acc * _R % FR_MOD)
        acc = acc * shift % FR_MOD
    flat = limb.ints_to_limbs(pows)  # natural order j
    idx = (np.arange(n2)[None, :] * n1 + np.arange(n1)[:, None]).reshape(-1)
    return flat[idx].reshape(n1, n2, limb.L)


def h_permutation(k1: int, k2: int) -> np.ndarray:
    """Position f of the sharded h holds the coset eval (f % N1) * N2 + f // N1."""
    q = np.arange(1 << (k1 + k2))
    return (q % (1 << k1)) * (1 << k2) + q // (1 << k1)


def _h_body(mesh: Mesh, k1: int, k2: int, aw, bw, tw_inv, coset_tw, tw_fwd):
    """Sharded twin of groth16.compute_h over this process's shards of the
    domain evals of A.w and B.w (C.w = their pointwise product) -> canonical
    coset evals of A.B - C in the doubly-permuted layout, one (N2/D, N1, 16)
    block per shard."""
    cw = []
    for _, dev, a, b in local(mesh, aw, bw):
        with on(dev):
            cw.append(limb.mont_mul(FR, a, b))  # C on the domain = A.B pointwise

    def to_coset(xs):
        # inverse four-step: coeffs in the transposed layout (N1/D, N2)
        ca = four_step_local(mesh, xs, tw_inv, k1, k2, inverse=True)
        m = []
        for _, dev, c, t in local(mesh, ca, coset_tw):
            with on(dev):  # elementwise coset shift, then the local transpose:
                # (N2, N1/D) is the column-sharded natural input of the (k2, k1) four-step
                m.append(limb.mont_mul(FR, c, t).transpose(0, 1))
        return four_step_local(mesh, m, tw_fwd, k2, k1)

    ea, eb, ec = to_coset(aw), to_coset(bw), to_coset(cw)
    out = []
    for _, dev, a, b, c in local(mesh, ea, eb, ec):
        with on(dev):
            out.append(limb.from_mont(FR, limb.sub(FR, limb.mont_mul(FR, a, b), c)))
    return out


@dataclass
class ShardedProvingKey:
    pk: ProvingKey
    mesh: Mesh
    k1: int
    k2: int
    queries: dict  # name ("a", "b1", "b2", "l", "h") -> ShardedPoints
    tw_inv: list  # the h stage's tables, this process's shards as _h_body reads them
    coset: list
    tw_fwd: list


def _key_digest(pk: ProvingKey) -> bytes:
    """SHA-256 of a key's verifying-key points (alpha1, beta1, delta1,
    beta2, delta2, with k and the public count) and of its five query
    tensors."""
    h = hashlib.sha256(repr((pk.k, pk.num_public, pk.alpha1, pk.beta1, pk.delta1,
                             pk.beta2, pk.delta2)).encode())
    for name, _ in MSM_QUERIES:
        for c in getattr(pk, name):
            h.update(repr(tuple(c.shape)).encode())
            h.update(c.cpu().numpy().tobytes())
    return h.digest()


def _check_same_key(pk: ProvingKey, mesh: Mesh):
    """On a mesh across processes, raise on every rank unless every rank
    holds the same key (a setup without a shared rng draws its own toxic
    waste in each process)."""
    if mesh.rank is None:
        return
    mine = np.frombuffer(_key_digest(pk), np.int32).copy()
    every = gather(mesh, [torch.from_numpy(mine).to(mesh.devices[mesh.rank])]).cpu()
    differ = [r for r in range(len(every)) if not torch.equal(every[r], every[0])]
    if differ:
        raise ValueError(f"shard_pk: the proving key of ranks {differ} differs from rank 0's; "
                         "give every rank the same key (one setup, then save_pk / load_pk, or "
                         "the same rng on every rank)")


def shard_pk(pk: ProvingKey, mesh: Mesh) -> ShardedProvingKey:
    """Partition a ProvingKey's MSM queries over the mesh (the one-time key
    distribution step; per proof only Jacobian partials and four-step
    transpose tiles move between shards). This process keeps its shards of
    each query, their K3 bases made by K6 on its cards, and its shards of
    the h stage's twiddle and coset tables, which live as long as the
    sharded key. On a mesh across processes every rank passes the whole
    key, and a key that is not the same on every rank is refused. The key's
    plan is left alone: the sharded prove is the plain path."""
    _check_same_key(pk, mesh)
    k1, k2 = _split_k(pk.k, len(mesh.devices))
    perm = h_permutation(k1, k2)  # h-eval layout after the double four-step
    first = mesh.devices[mesh.rank or 0]  # the rule's card: this process's first shard's
    ws = (key_windows(pk, first) if first.type == "cuda"
          else dict.fromkeys((q for q, _ in MSM_QUERIES), msm.N_WINDOWS))
    queries = {
        name: _pad_shard_points(getattr(pk, f"{name}_query"), mesh,
                                perm=perm if name == "h" else None, windows=ws[f"{name}_query"])
        for name in ("a", "b1", "b2", "l", "h")
    }
    shift = ntt.domain_root(pk.k + 1)
    return ShardedProvingKey(
        pk=pk, mesh=mesh, k1=k1, k2=k2, queries=queries,
        tw_inv=table_shards(mesh, _outer_twiddle(k1, k2, True), 1),
        coset=table_shards(mesh, _coset_table_transposed(k1, k2, shift), 0),
        tw_fwd=table_shards(mesh, _outer_twiddle(k2, k1, False), 1))


def compute_h_sharded(spk: ShardedProvingKey, witness) -> list:
    """Canonical coset evals of A.B - C in the permuted layout that matches
    spk.queries['h']: this process's shards (n / D, 16), in mesh order."""
    pk, mesh, k1, k2 = spk.pk, spk.mesh, spk.k1, spk.k2
    n = 1 << pk.k
    W = witness.to(pk.mats[0][2].device)[None]
    aw, bw = (shard(mesh, sparse_matvec_mont(mat, W, n)[0].reshape(1 << k1, 1 << k2, limb.L),
                    dim=1) for mat in pk.mats[:2])
    h = _h_body(mesh, k1, k2, aw, bw, spk.tw_inv, spk.coset, spk.tw_fwd)
    return [x.reshape(n // len(mesh.devices), limb.L) for x in h]


def prove_sharded(spk: ShardedProvingKey, witness_limbs, r: int | None = None,
                  s: int | None = None):
    """One Groth16 proof computed across the mesh. witness_limbs:
    (num_wires, 16) canonical limbs with w[0] == 1. Mesh-shape invariant:
    the proof depends only on (witness, r, s). r and s left None are drawn
    at random; on a mesh across processes rank 0's r and s go to every
    rank, so every rank returns the same proof."""
    pk, mesh, q = spk.pk, spk.mesh, spk.queries
    w = torch.as_tensor(np.asarray(witness_limbs, np.int32)) if not torch.is_tensor(
        witness_limbs) else witness_limbs
    w = w.to(pk.a_query[0].device)
    npub = pk.num_public
    r, s = broadcast_ints(mesh, [secrets.randbelow(FR_MOD) if r is None else r,
                                 secrets.randbelow(FR_MOD) if s is None else s])
    h = compute_h_sharded(spk, w)  # already in q["h"]'s shards
    a_sum = msm_sharded(mesh, q["a"], w)
    b1_sum = msm_sharded(mesh, q["b1"], w)
    b2_sum = msm_sharded(mesh, q["b2"], w)
    c_l = msm_sharded(mesh, q["l"], w[npub + 1:]) if q["l"].m > 0 else None
    c_h = msm_sharded(mesh, q["h"], h)
    return finish_proof(pk, (a_sum, b1_sum, b2_sum, c_l, c_h), r, s)
