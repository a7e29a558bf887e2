"""Port curve arithmetic and MSMs (pob_tpu_torch.prover.curve / msm, plain
paths of kernels K3 and K4) against pob_tpu.prover.curve / msm and the
python-int reference. Points are compared in affine form, except point_add
against the JAX point_add, whose formulas the port keeps, so the Jacobian
limbs are equal too. Tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pob_tpu.field import limb as jl
from pob_tpu.prover import curve as jc
from pob_tpu.prover import msm as jm
from pob_tpu_torch.field import limb as tl
from pob_tpu_torch.field.ref import (
    FR_MOD, G1_GEN, G2_GEN, g1_add, g1_mul, g1_neg, g2_add, g2_mul, g2_neg,
)
from pob_tpu_torch.prover import curve as tc
from pob_tpu_torch.prover import msm as tm

torch.set_num_threads(1)

GROUPS = {
    "g1": (G1_GEN, g1_add, g1_mul, g1_neg, jc.FqOps, jc.g1_points_to_device),
    "g2": (G2_GEN, g2_add, g2_mul, g2_neg, jc.Fq2Ops, jc.g2_points_to_device),
}


def _scalars(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_point_add_double_cases(group):
    """Pairwise adds (P0+P1, P2+P3, P4+inf), doubling through add(P, P),
    cancel P + (-P), inf + P, point_double and tree_reduce: equal to the JAX
    point_add (Jacobian limbs) and to the reference (affine)."""
    gen, add, mul, neg, jops, j_to_dev = GROUPS[group]
    ops = tc.ops_for(group)
    pts = [mul(gen, k) for k in _scalars(5, 21)] + [None]
    host = [np.asarray(c) for c in j_to_dev(pts)]
    port = tc.points_to_device(group, pts, "cpu")
    for h, p in zip(host, port):
        np.testing.assert_array_equal(p.numpy(), h.astype(np.int32))
    a_t = tuple(c[0::2] for c in port)
    b_t = tuple(c[1::2] for c in port)
    neg_t = tc.points_to_device(group, [neg(pts[0]), neg(pts[2]), pts[4]], "cpu")
    inf_t = tc.infinity(ops, (3,), "cpu")
    jadd = jax.jit(lambda a, b: jc.point_add(jops, a, b))
    cases = [
        (a_t, b_t, [add(pts[0], pts[1]), add(pts[2], pts[3]), pts[4]]),
        (a_t, a_t, [mul(p, 2) for p in pts[0::2]]),
        (a_t, neg_t, [None, None, mul(pts[4], 2)]),
        (inf_t, a_t, pts[0::2]),
    ]
    for p, q, want in cases:
        got = tc.point_add(ops, p, q)
        ref_j = jadd(tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in p),
                     tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in q))
        for g, r in zip(got, ref_j):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r).astype(np.int32))
        assert tc.to_affine_host_batch(ops.name, got) == want
        want_t = tc.points_to_device(group, want, "cpu")
        assert tc.points_equal(ops, got, want_t).tolist() == [True] * 3
        assert tc.points_equal(ops, got, tuple(c.roll(1, 0) for c in want_t)).tolist() == [
            want[i] == want[i - 1] for i in range(3)]
    dbl = tc.point_double(ops, a_t)
    assert tc.to_affine_host_batch(ops.name, dbl) == [
        mul(p, 2) if p is not None else None for p in pts[0::2]]
    total = None
    for p in pts:
        total = add(total, p)
    assert tc.to_affine_host(ops.name, tc.tree_reduce(ops, port)) == total


def test_msm_plain_matches_jax_pippenger():
    """K3's plain version against msm.pippenger_msm (G1) and a g1_mul sum, with
    a point at infinity and a zero scalar."""
    m = 13
    scalars = _scalars(m, 31) + [0]
    pts = [g1_mul(G1_GEN, k) for k in _scalars(m, 32)] + [None]
    jpts = jc.g1_points_to_device(pts)
    jsc = jnp.asarray(jl.ints_to_limbs(scalars))
    want = jax.jit(lambda p, s: jm.pippenger_msm_g1(p, s, n_tiles=4))(jpts, jsc)
    got = tm.msm_batched("g1", tc.g1_points_to_device(pts, "cpu"),
                         torch.from_numpy(tl.ints_to_limbs(scalars))[None])
    expect = None
    for s, p in zip(scalars, pts):
        expect = g1_add(expect, g1_mul(p, s) if p is not None else None)
    assert jc.to_affine_host("fq", want) == expect
    assert tc.to_affine_host("fq", tuple(c[0] for c in got)) == expect


def test_msm_plain_g2_batched_vs_ref():
    """K3's plain version on G2, batch of 2, with repeated points (doubling),
    a point and its negation (cancel), infinity and zero scalars."""
    base = [g2_mul(G2_GEN, k) for k in _scalars(3, 41)]
    pts = [base[0], base[0], base[1], g2_neg(base[1]), None, base[2]]
    sc = [_scalars(6, 42), _scalars(6, 43)]
    sc[0][1] = sc[0][0]
    sc[1][2] = sc[1][3] = 7
    sc[1][5] = 0
    got = tm.msm_batched("g2", tc.g2_points_to_device(pts, "cpu"),
                         torch.from_numpy(np.stack([tl.ints_to_limbs(s) for s in sc])))
    for b in range(2):
        expect = None
        for s, p in zip(sc[b], pts):
            expect = g2_add(expect, g2_mul(p, s) if p is not None else None)
        assert tc.to_affine_host("fq2", tuple(c[b] for c in got)) == expect


@pytest.mark.parametrize("top", [None, 0, 127, 128, 255])
def test_msm_plain_fold_edges(top):
    """K3's plain version folds only the bit positions below the next power
    of two above the highest set bit of its scalars: against g1_mul sums
    where that bit is 0 (one position), 127 (128 positions, all used), 128
    (256 positions, from 129 used) and 255 (a 256-bit integer, above Fr:
    the fold is over the integer's digits), and with every scalar zero.
    Row 1 of the batch stays below row 0's top bit."""
    pts = [g1_mul(G1_GEN, k) for k in _scalars(3, 51)]
    if top is None:
        sc = [[0, 0, 0], [0, 0, 0]]
    else:
        low = [k % (1 << top) for k in _scalars(6, 52)]
        sc = [[(1 << top) | low[0], low[1], 0], [low[2] >> 1, low[3], low[4]]]
    got = tm.msm_batched("g1", tc.g1_points_to_device(pts, "cpu"),
                         torch.from_numpy(np.stack([tl.ints_to_limbs(s) for s in sc])))
    for b in range(2):
        expect = None
        for s, p in zip(sc[b], pts):
            expect = g1_add(expect, g1_mul(p, s))
        assert tc.to_affine_host("fq", tuple(c[b] for c in got)) == expect, b


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_fixed_base_plain_vs_ref(group):
    """K4's plain version: k_i * G for scalars including 0, 1 and r - 1."""
    gen, _, mul, _, _, _ = GROUPS[group]
    scalars = [0, 1, FR_MOD - 1] + _scalars(3, 51)
    got = tm.fixed_base_msm(group, torch.from_numpy(tl.ints_to_limbs(scalars)))
    assert tc.to_affine_host_batch(tc.ops_for(group).name, got) == [
        mul(gen, s) if s else None for s in scalars]


def test_kernel_paths_refuse_cpu_tensors():
    pts = tc.g1_points_to_device([G1_GEN], "cpu")
    sc = torch.zeros(1, 1, 16, dtype=torch.int32)
    with pytest.raises(ValueError):
        tm.pippenger_cuda("g1", pts, sc)
    with pytest.raises(ValueError):
        tm.fixed_base_window_cuda("g1", torch.zeros(tm.TABLE_ROWS, 16, dtype=torch.int32),
                                  sc[0])
