"""The port's Groth16 slice as a whole, on the CPU (plain paths of K1-K4):
a toy circuit keyed by pob_tpu's setup_host is saved with save_pk, read by
the port's load_pk, and proved by both packages with the same (r, s); the
proofs must be equal and verify under both packages. The port's own setup,
under the same rng, must give the same affine key points as setup_host.

pob_tpu's side of the proof is its plain prove path taken apart: its h
stage (_h_batch_kernel), the five MSMs by double-and-add with its jitted
point_add and point_double, and its finish_proof. Its own MSM programs
(_msm_batch_kernel, one per query size) cost minutes of tracing on the CPU;
test_torch_curve_msm holds the port's MSM against pob_tpu's Pippenger."""

import functools
import random
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_groth16 import toy_cs, toy_witness  # noqa: E402

from pob_tpu.field import limb as jl  # noqa: E402
from pob_tpu.prover import curve as jc  # noqa: E402
from pob_tpu.prover import groth16 as jg  # noqa: E402
from pob_tpu_torch.field import limb as tl  # noqa: E402
from pob_tpu_torch.field.ref import FR_MOD  # noqa: E402
from pob_tpu_torch.prover import curve as tc  # noqa: E402
from pob_tpu_torch.prover import groth16 as tg  # noqa: E402

torch.set_num_threads(1)

SEED_SCALARS = [random.Random(7).randrange(1, FR_MOD) for _ in range(5)]


def _rng():
    return iter(SEED_SCALARS).__next__


@pytest.fixture(scope="module")
def keyed(tmp_path_factory):
    cs = toy_cs()
    pk, vk = jg.setup_host(cs, rng=_rng())
    path = str(tmp_path_factory.mktemp("pk") / "toy_pk.npz")
    jg.save_pk(path, pk, vk)
    return cs, pk, vk, path


@functools.lru_cache(maxsize=None)
def _jax_curve(group: str):
    jops = jc.FqOps if group == "g1" else jc.Fq2Ops
    return (jops, jax.jit(lambda p, q: jc.point_add(jops, p, q)),
            jax.jit(lambda p: jc.point_double(jops, p)))


def _jax_msm(group: str, points, scalars):
    """sum_i s[b, i] P_i for every b: MSB-first double-and-add with pob_tpu's
    point_add and point_double, one jitted program each. points: (m, ...)
    uint32 Jacobian; scalars: (B, m, 16) canonical limbs."""
    jops, add, dbl = _jax_curve(group)
    pts = [np.asarray(c) for c in points]
    sc = np.asarray(scalars, np.int64)
    B, m = sc.shape[:2]
    bits = ((sc[..., :, None] >> np.arange(16)) & 1).reshape(B, m, 256)
    inf = [np.asarray(c) for c in jc.infinity(jops, (B,))]
    acc = tuple(jnp.asarray(c) for c in inf)
    for e in range(int(np.flatnonzero(bits.any((0, 1)))[-1]) if bits.any() else -1, -1, -1):
        acc = dbl(acc)
        for i in np.flatnonzero(bits[:, :, e].any(0)):
            sel = bits[:, i, e].astype(bool)
            acc = add(acc, tuple(
                jnp.asarray(np.where(sel.reshape((B,) + (1,) * (c.ndim - 1)), c[i], z))
                for c, z in zip(pts, inf)))
    return tuple(np.asarray(c) for c in acc)


def test_toy_proofs_equal_jax(keyed):
    cs, pk, vk, path = keyed
    tpk, tvk = tg.load_pk(path, device="cpu")
    assert tpk.k == pk.k and tvk.ic == vk.ic
    cases = [toy_witness(100 + i, 7000 + 13 * i) for i in range(4)]
    W = np.stack([jl.ints_to_limbs(w) for w, _ in cases])
    rs = [(i + 1, i + 2) for i in range(4)]
    got = tg.prove_batch(tpk, torch.from_numpy(W.astype(np.int32)), rs=rs)
    npub = pk.num_public
    h = np.asarray(jg._h_batch_kernel(pk.k, pk.mats, jnp.asarray(W)))
    sums = [_jax_msm("g1", pk.a_query, W), _jax_msm("g1", pk.b1_query, W),
            _jax_msm("g2", pk.b2_query, W), _jax_msm("g1", pk.l_query, W[:, npub + 1:]),
            _jax_msm("g1", pk.h_query, h)]
    want = [jg.finish_proof(pk, [tuple(c[i] for c in p) for p in sums], r, s)
            for i, (r, s) in enumerate(rs)]
    assert got == want
    for i, (proof, (_, pub)) in enumerate(zip(got, cases)):
        assert tg.verify(tvk, proof, pub), i
        assert jg.verify(vk, proof, pub), i
    assert not tg.verify(tvk, got[1], cases[0][1])


def test_setup_matches_setup_host(keyed):
    cs, pk, vk, _ = keyed
    tpk, tvk = tg.setup(cs, rng=_rng(), device="cpu")
    assert (tpk.alpha1, tpk.beta1, tpk.delta1, tpk.beta2, tpk.delta2) == (
        pk.alpha1, pk.beta1, pk.delta1, pk.beta2, pk.delta2)
    assert tvk.ic == vk.ic and tvk.gamma2 == vk.gamma2
    for name in ("a_query", "b1_query", "b2_query", "l_query", "h_query"):
        group = "fq2" if name == "b2_query" else "fq"
        jp = getattr(pk, name)
        want = [jc.to_affine_host(group, tuple(np.asarray(c)[i] for c in jp))
                for i in range(int(jp[0].shape[0]))]
        assert tc.to_affine_host_batch(group, getattr(tpk, name)) == want, name
    for (r, c, f), (jr, jcol, jf) in zip(tpk.mats, pk.mats):
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jcol))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf).astype(np.int32))


def test_entry_points_need_a_device_or_cpu():
    """Without a card, the default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        tg.setup(toy_cs(), rng=_rng())


def test_sparse_matvec_chunks_match_ints(monkeypatch):
    """sparse_matvec_mont in chunks of 3 nonzeros and 3 rows (the card's
    path at domain 2^22 goes 2^20 at a time) equals one chunk and the python
    ints: row i of A W is sum c W[col] over the nonzeros of row i."""
    rng = np.random.default_rng(81)
    n, nw, nnz, B = 8, 6, 20, 2
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, nw, nnz)
    coef = [int(x) % FR_MOD for x in rng.integers(1, 1 << 62, nnz)] + [FR_MOD - 1]
    rows, cols = np.append(rows, 0), np.append(cols, 1)
    r2 = pow(2, 512, FR_MOD)
    mat = (torch.from_numpy(rows), torch.from_numpy(cols),
           torch.from_numpy(tl.ints_to_limbs([c * r2 % FR_MOD for c in coef])))
    w = [[int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(nw)] for _ in range(B)]
    W = torch.from_numpy(np.stack([tl.ints_to_limbs(x) for x in w]))
    whole = tg.sparse_matvec_mont(mat, W, n)
    monkeypatch.setattr(tg, "MATVEC_CHUNK", 3)
    chunked = tg.sparse_matvec_mont(mat, W, n)
    assert torch.equal(chunked, whole)
    r = (1 << 256) % FR_MOD
    for b in range(B):
        want = [0] * n
        for i, j, c in zip(rows, cols, coef):
            want[i] = (want[i] + c * w[b][j]) % FR_MOD
        assert tl.limb_rows_to_ints(chunked[b].numpy()) == [x * r % FR_MOD for x in want]


def test_prove_batch_in_chunks_equals_one_pass(keyed, monkeypatch):
    """With its chunk limited to 2, prove_batch proves B = 5 in three passes
    (2, 2, 1); with fixed (r, s) the proofs equal those of one pass."""
    _, _, _, path = keyed
    tpk, _ = tg.load_pk(path, device="cpu")
    cases = [toy_witness(200 + i, 5000 + 31 * i) for i in range(5)]
    W = torch.from_numpy(np.stack([tl.ints_to_limbs(w) for w, _ in cases]))
    rs = [(10 + i, 20 + i) for i in range(5)]
    whole = tg.prove_batch(tpk, W, rs=rs)
    monkeypatch.setattr(tg, "batch_chunk", lambda pk, B, device: 2)
    tm = {}
    assert tg.prove_batch(tpk, W, rs=rs, timings=tm) == whole
    assert tm["chunk"] == 2 and tm["h_s"] > 0 and tm["msm_s"] > 0


def test_batch_chunk_rule(keyed, monkeypatch):
    """The chunk is the least of B, K3's int32 limit over the largest query
    and, on the card, MEM_SHARE of free memory over h_stage_bytes."""
    from pob_tpu_torch.prover import msm as tm_

    _, _, _, path = keyed
    tpk, _ = tg.load_pk(path, device="cpu")
    cpu = torch.device("cpu")
    m = max(1 << tpk.k, int(tpk.a_query[0].shape[0]))
    assert tg.batch_chunk(tpk, 3, cpu) == 3
    assert tg.batch_chunk(tpk, 1 << 40, cpu) == tm_.k3_max_batch(m) == ((1 << 31) - 1) // (32 * m)
    assert tm_.k3_max_batch(1 << 22) == 15 and tm_.k3_max_batch(1 << 18) == 255
    # the PoB key (domain 2^22): 3.49 GB per proof; 26 GB free, 2 GB cached
    assert tg.h_stage_bytes(22) == 320 * (1 << 22) + 2048 * (1 << 20)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d: (26 * 10**9, 80 * 10**9))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda d: 60 * 10**9)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d: 58 * 10**9)
    pob_like = type("K", (), {"k": 22, "a_query": (torch.zeros(3_962_976, 0),)})()
    assert tg.batch_chunk(pob_like, 16, torch.device("cuda")) == int(28e9 * 0.9) // tg.h_stage_bytes(22) == 7
    assert tg.batch_chunk(pob_like, 4, torch.device("cuda")) == 4
