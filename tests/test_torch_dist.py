"""The port's multi-device layer (pob_tpu_torch/dist) on virtual CPU meshes
(data_mesh(D, device="cpu")), held against pob_tpu/dist and the port's own
local functions: the host tables bit for bit; the four-step NTT against
pob_tpu's ntt_sharded on its 8 virtual devices and against the local
transform (inverse included) at D = 1, 2, 4, 8; the sharded MSM against
the field/ref.py sum; the sharded h stage against compute_h under the h
permutation; the sharded prove against the port's prove at fixed (r, s).

pob_tpu's prove_sharded is no oracle here: its four-step puts the gathered
axis of the all_to_all at 2, which keeps the natural order only when a
shard holds one column (2^k2 = D), as in its own tests."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_dist import _medium_cs, _medium_witness  # noqa: E402

from pob_tpu.dist import mesh as jmesh  # noqa: E402
from pob_tpu.dist import ntt_sharded as jns  # noqa: E402
from pob_tpu.dist import prove_sharded as jps  # noqa: E402
from pob_tpu_torch.dist import ntt_sharded as tns  # noqa: E402
from pob_tpu_torch.dist import prove_sharded as tps  # noqa: E402
from pob_tpu_torch.dist.mesh import Mesh, all_gather, all_to_all, data_mesh, gather  # noqa: E402
from pob_tpu_torch.dist.msm_sharded import msm_g1_sharded, msm_g2_sharded  # noqa: E402
from pob_tpu_torch.field import limb as tl  # noqa: E402
from pob_tpu_torch.field.ref import (  # noqa: E402
    FR_MOD, G1_GEN, G2_GEN, g1_add, g1_mul, g2_add, g2_mul,
)
from pob_tpu_torch.prover import curve, groth16, ntt  # noqa: E402
from pob_tpu_torch.r1cs.builder import ConstraintSystem  # noqa: E402

torch.set_num_threads(1)

_R = (1 << 256) % FR_MOD


def _mont_vector(n: int):
    return tl.to_device(tl.ints_to_limbs([(i * 7919 + 13) % FR_MOD * _R % FR_MOD
                                          for i in range(n)]), "cpu")


@pytest.mark.parametrize("k1,k2", [(3, 3), (2, 4), (4, 2), (1, 3)])
def test_host_tables_equal_pob_tpu(k1, k2):
    for inverse in (False, True):
        np.testing.assert_array_equal(tns._outer_twiddle(k1, k2, inverse),
                                      np.asarray(jns._outer_twiddle(k1, k2, inverse), np.int64))
    shift = ntt.domain_root(k1 + k2 + 1)
    np.testing.assert_array_equal(tps._coset_table_transposed(k1, k2, shift),
                                  np.asarray(jps._coset_table_transposed(k1, k2, shift), np.int64))
    n1, n2 = 1 << k1, 1 << k2
    q = np.arange(n1 * n2)
    np.testing.assert_array_equal(tps.h_permutation(k1, k2), (q % n1) * n2 + q // n1)


def test_split_k_equals_pob_tpu():
    for k in range(0, 20):
        for ndev in (1, 2, 3, 4, 8):
            try:
                want = jps._split_k(k, ndev)
            except AssertionError:
                with pytest.raises(ValueError):
                    tps._split_k(k, ndev)
                continue
            assert tps._split_k(k, ndev) == want, (k, ndev)


def test_collectives_give_each_shard_its_own_tensor():
    mesh = data_mesh(4, device="cpu")
    parts = [torch.full((2, 3), i) for i in range(4)]
    g = all_gather(mesh, parts)
    assert all(torch.equal(x, torch.stack(parts)) for x in g)
    g[0][1] += 100  # no other shard sees it
    assert torch.equal(g[1], torch.stack(parts)) and torch.equal(parts[1], torch.full((2, 3), 1))
    one = gather(mesh, parts, 2)
    assert torch.equal(one, torch.stack(parts))
    one[3] += 1
    assert torch.equal(parts[3], torch.full((2, 3), 3))
    blocks = [torch.arange(4 * 2 * 3).reshape(4, 2, 3) + 100 * s for s in range(4)]
    out = all_to_all(mesh, blocks, 0, 1)
    for r in range(4):
        assert tuple(out[r].shape) == (2, 4, 3)
        for s in range(4):
            assert torch.equal(out[r][:, s], blocks[s][r])
    out[0].zero_()
    assert blocks[0].abs().sum() > 0 and out[1].abs().sum() > 0


def test_data_mesh_needs_the_cards():
    assert data_mesh(3, device="cpu") == Mesh(("cpu",) * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            data_mesh(1)
        with pytest.raises(RuntimeError):
            data_mesh(2, device="cuda")


def test_ntt_sharded_equals_pob_tpu():
    """k1 = k2 = 3 on 8 devices, the size of test_dist's
    test_ntt_sharded_matches_local: pob_tpu's mesh there is its 8 virtual CPU
    devices."""
    a = _mont_vector(64)
    want = jns.untranspose_host(jns.ntt_sharded(jmesh.data_mesh(8),
                                                jnp.asarray(a.numpy().astype(np.uint32)), 3, 3))
    got = tns.untranspose_host(tns.ntt_sharded(data_mesh(8, device="cpu"), a, 3, 3))
    np.testing.assert_array_equal(got, np.asarray(want, np.int64))


@pytest.mark.parametrize("k1,k2,D", [(3, 3, 1), (3, 3, 2), (3, 3, 4), (3, 3, 8), (2, 4, 2),
                                     (4, 2, 4), (3, 5, 8)])
@pytest.mark.parametrize("inverse", [False, True], ids=["ntt", "intt"])
def test_ntt_sharded_equals_local(k1, k2, D, inverse):
    a = _mont_vector(1 << (k1 + k2))
    c = tns.ntt_sharded(data_mesh(D, device="cpu"), a, k1, k2, inverse=inverse)
    assert len(c) == D and all(tuple(b.shape) == ((1 << k1) // D, 1 << k2, 16) for b in c)
    local = (ntt.intt if inverse else ntt.ntt)(a, k1 + k2)
    np.testing.assert_array_equal(tns.untranspose_host(c), local.numpy())


@pytest.mark.parametrize("group,m,D", [("g1", 16, 8), ("g2", 5, 2)])
def test_msm_sharded_matches_ref(group, m, D):
    """G1 as test_dist's test_msm_sharded_matches_ref; G2 with m not a
    multiple of D (one point of infinity padding). The group comes from the
    points' shape; the other group's entry point refuses them."""
    gen, add, mul, to_dev, fn, other = {
        "g1": (G1_GEN, g1_add, g1_mul, curve.g1_points_to_device, msm_g1_sharded,
               msm_g2_sharded),
        "g2": (G2_GEN, g2_add, g2_mul, curve.g2_points_to_device, msm_g2_sharded,
               msm_g1_sharded)}[group]
    scalars = [(i * 37 + 5) % FR_MOD for i in range(m)]
    pts = [mul(gen, i + 3) for i in range(m)]
    mesh = data_mesh(D, device="cpu")
    dev_pts = to_dev(pts, "cpu")
    sc = tl.to_device(tl.ints_to_limbs(scalars), "cpu")
    out = fn(mesh, dev_pts, sc)
    expect = None
    for s, p in zip(scalars, pts):
        expect = add(expect, mul(p, s))
    assert curve.to_affine_host("fq" if group == "g1" else "fq2", out) == expect
    with pytest.raises(ValueError):
        other(mesh, dev_pts, sc)


@pytest.fixture(scope="module")
def medium_key():
    """The matrices of test_dist's _medium_cs (domain 2^6) in a key whose
    query points are all infinity: the h stage reads only k and the
    matrices, and shard_pk only splits the points."""
    cs = _medium_cs()
    k, _, host_mats = groth16.setup_scalars(cs, (2, 3, 5, 7, 11))
    inf = {g: curve.infinity(curve.ops_for(g), (cs.num_wires,), "cpu") for g in ("g1", "g2")}
    return groth16.ProvingKey(
        k=k, num_public=cs.num_public, alpha1=None, beta1=None, delta1=None, beta2=None,
        delta2=None, a_query=inf["g1"], b1_query=inf["g1"], b2_query=inf["g2"],
        l_query=inf["g1"], h_query=curve.infinity(curve.FqOps, (1 << k,), "cpu"),
        mats=groth16._mats_to_device(host_mats, "cpu"))


@pytest.mark.parametrize("D", [1, 2, 4, 8])
def test_compute_h_sharded_matches_local(medium_key, D):
    pk = medium_key
    w, _ = _medium_witness(7, 11)
    W = tl.to_device(tl.ints_to_limbs(w), "cpu")
    local = groth16.compute_h(pk.k, pk.mats, W[None])[0].numpy()
    spk = tps.shard_pk(pk, data_mesh(D, device="cpu"))
    h = tps.compute_h_sharded(spk, W)
    assert len(h) == D
    np.testing.assert_array_equal(torch.cat(h).numpy(), local[tps.h_permutation(spk.k1, spk.k2)])


def _line_cs(n: int = 11):
    """x, y private; publics z1 = x y, z2 = (x + y) x (test_groth16's toy_cs)
    and a chain c_0 = x + y, c_i = c_{i-1} + x: 13 constraints, domain 2^4
    (the least that splits over 4 devices), small witness values."""
    cs = ConstraintSystem()
    z1, z2 = (int(v) for v in cs.alloc_block("pub", (2,)))
    cs.mark_public(2)
    x, y = (int(v) for v in cs.alloc_block("priv", (2,)))
    chain = [int(v) for v in cs.alloc_block("chain", (n,))]
    cs.add([(x, 1)], [(y, 1)], [(z1, 1)])
    cs.add([(x, 1), (y, 1)], [(x, 1)], [(z2, 1)])
    cs.add([(x, 1), (y, 1)], [(0, 1)], [(chain[0], 1)])
    for i in range(1, n):
        cs.add([(chain[i - 1], 1), (x, 1)], [(0, 1)], [(chain[i], 1)])
    return cs


def _line_witness(x: int, y: int, n: int = 11):
    chain = [(x + y + i * x) % FR_MOD for i in range(n)]
    z1, z2 = x * y % FR_MOD, (x + y) * x % FR_MOD
    return [1, z1, z2, x, y] + chain, [z1, z2]


def test_prove_sharded_equals_prove():
    """At D = 2, 4 (one test: each CPU shard adds plain MSM calls, and the
    key and the reference proof are made once). D = 1 is in
    test_torch_pipeline, held there against pob_tpu's proof too."""
    cs = _line_cs()
    w, pub = _line_witness(31415, 92653)
    assert cs.check_witness(w)
    pk, vk = groth16.setup(cs, rng=iter(range(101, 200, 7)).__next__, plan=False, device="cpu")
    assert pk.k == 4
    witness = tl.ints_to_limbs(w)
    reference = groth16.prove(pk, witness, r=1234, s=5678)
    assert groth16.verify(vk, reference, pub)
    assert not groth16.verify(vk, reference, [pub[0], (pub[1] + 1) % FR_MOD])
    for D in (2, 4):
        spk = tps.shard_pk(pk, data_mesh(D, device="cpu"))
        assert (spk.k1, spk.k2) == tps._split_k(4, D)
        assert tps.prove_sharded(spk, witness, r=1234, s=5678) == reference, D
