"""The port's planned witness-MSM path (pob_tpu_torch.prover.groth16:
classify_bit_wires, MsmPlan, attach_msm_plan, the K5 sweep's and K6's plain
versions) against pob_tpu and field/ref.py ints, on the CPU.

The key is pob_tpu's setup_host key of tests/test_groth16.py's bit_cs,
carried into the port by save_pk / load_pk. The planned proof is held
against the port's plain proof for the same (r, s), bit for bit, and
verified: the contract of pob_tpu's test_classified_msm_plan_matches_plain,
whose own planned prove is not an oracle (it fails on this tree). Of
pob_tpu's plan code only attach_msm_plan runs here (its classification,
index arrays and jitted doubling scan); no pob_tpu MSM program is traced."""

import random
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_groth16 import bit_cs, toy_cs  # noqa: E402

from pob_tpu.prover import curve as jc  # noqa: E402
from pob_tpu.prover import groth16 as jg  # noqa: E402
from pob_tpu.r1cs import spend_circuit as jsc  # noqa: E402
from pob_tpu_torch.field import limb as tl  # noqa: E402
from pob_tpu_torch.field.ref import (FR_MOD, G1_GEN, G2_GEN, g1_add, g1_mul,  # noqa: E402
                                     g2_add, g2_mul)
from pob_tpu_torch.prover import bitsum, curve, msm  # noqa: E402
from pob_tpu_torch.prover import groth16 as tg  # noqa: E402
from pob_tpu_torch.r1cs import spend_circuit as tsc  # noqa: E402

torch.set_num_threads(1)

SEED_SCALARS = [random.Random(23).randrange(1, FR_MOD) for _ in range(5)]
X = 0xBEEF
BIT_W = [1, X, X] + [(X >> i) & 1 for i in range(16)]


def _witness():
    return torch.from_numpy(tl.ints_to_limbs(BIT_W))


@pytest.fixture(scope="module")
def keyed(tmp_path_factory):
    """(cs, pob_tpu pk with its plan, vk, the port's pk with its plan, vk,
    dir)."""
    d = tmp_path_factory.mktemp("plan")
    cs = bit_cs()
    pk, vk = jg.setup_host(cs, rng=iter(SEED_SCALARS).__next__)
    jg.save_pk(str(d / "pk.npz"), pk, vk)
    jg.attach_msm_plan(pk, cs)
    tpk, tvk = tg.load_pk(str(d / "pk.npz"), device="cpu")
    assert tpk.plan is None
    tg.attach_msm_plan(tpk, cs)
    return cs, pk, vk, tpk, tvk, d


def _jax_plan(pk):
    p = pk.plan
    return {"g1": (p.g1_pts, p.g1_bit_idx, p.g1_full_idx),
            "g2": (p.g2_pts, p.g2_bit_idx, p.g2_full_idx)}


def _affine_from_packed(group, pts):
    """(q, M, width) packed affine words -> q lists of host affine points."""
    q, M, w = pts.shape
    jac = msm.packed_to_jacobian(group, pts.reshape(q * M, w))
    aff = curve.to_affine_host_batch(curve.ops_for(group).name, jac)
    return [aff[i * M:(i + 1) * M] for i in range(q)]


def _affine_from_jax(group, coords):
    name = "fq" if group == "g1" else "fq2"
    c = [np.asarray(x) for x in coords]
    return [[jc.to_affine_host(name, tuple(x[qi, i] for x in c)) for i in range(c[0].shape[1])]
            for qi in range(c[0].shape[0])]


def _same_plan_as_jax(tplan, jax_arrays):
    for group in ("g1", "g2"):
        g = getattr(tplan, group)
        pts, bidx, fidx = jax_arrays[group]
        np.testing.assert_array_equal(g.bit_idx.numpy(), np.asarray(bidx))
        np.testing.assert_array_equal(g.full_idx.numpy(), np.asarray(fidx))
        assert tuple(g.pts.shape[:2]) == tuple(np.asarray(pts[0]).shape[:2]), group
        assert _affine_from_packed(group, g.pts) == _affine_from_jax(group, pts), group


@pytest.mark.parametrize("which", ["toy", "bit", "spend"])
def test_classify_bit_wires_matches_jax(which):
    if which == "spend":
        tcs, jcs = tsc.build_spend_cs(), jsc.build_spend_cs()
    else:
        tcs = jcs = {"toy": toy_cs, "bit": bit_cs}[which]()
    got = tg.classify_bit_wires(tcs)
    want = jg.classify_bit_wires(jcs)
    assert got.dtype == bool and got.shape == (jcs.num_wires,)
    np.testing.assert_array_equal(got, want)
    if which == "bit":
        assert not got[:3].any() and got[3:19].all()
    if which == "spend":
        assert 0 < got.sum() < jcs.num_wires


def test_plan_equals_jax_attach_msm_plan(keyed):
    """Index arrays equal; points equal as affine points; counts as built."""
    cs, pk, _, tpk, _, _ = keyed
    _same_plan_as_jax(tpk.plan, _jax_plan(pk))
    bit = jg.classify_bit_wires(cs)
    npub = cs.num_public
    for group, names in tg.PLAN_GROUPS:
        g = getattr(tpk.plan, group)
        for qi, name in enumerate(names):
            off = npub + 1 if name == "l_query" else 0
            z = getattr(tpk, name)[2]
            live = (z.reshape(z.shape[0], -1) != 0).any(1).numpy()
            wires = np.arange(len(live)) + off
            assert g.counts[qi].tolist() == [int((bit[wires] & live).sum()),
                                             int((~bit[wires] & live).sum())], name


def test_chains_plain_match_ref_ints():
    """K6's plain version at (254, 1, wire-major), (1, 0) and (32, 8)
    against host doublings, on G1 and G2, infinity included."""
    for group, gen, mul, add in (("g1", G1_GEN, g1_mul, g1_add), ("g2", G2_GEN, g2_mul, g2_add)):
        ks = [3, 0, 12345]
        pts = curve.points_to_device(group, [mul(gen, k) if k else None for k in ks], "cpu")
        for windows, dbl, wm in ((254, 1, True), (1, 0, False), (32, 8, False)):
            got = _affine_from_packed(group, msm.affine_bases_plain(group, pts, windows, dbl, wm)[
                None])[0]
            rows = [[mul(gen, k) if k else None for k in ks]]
            for _ in range(windows - 1):
                row = rows[-1]
                for _ in range(dbl):
                    row = [add(p, p) for p in row]
                rows.append(row)
            want = ([rows[w][i] for i in range(len(ks)) for w in range(windows)] if wm
                    else [p for row in rows for p in row])
            assert got == want, (group, windows, dbl)


def _synthetic_group(group, nbits, nfulls, mb, mf, M, seed):
    """A hand-made plan group over points k G: per query nbits[q] bit points
    and nfulls[q] full wires, padded to mb, mf and M; the wires are
    1, 2, ... (bit wires first). Returns (pts, bit_idx, full_idx, counts,
    the host points of each query's bit and full wires, nw)."""
    rng = random.Random(seed)
    gen, mul = (G1_GEN, g1_mul) if group == "g1" else (G2_GEN, g2_mul)
    q = len(nbits)
    nw = 1 + max(b + f for b, f in zip(nbits, nfulls))
    width = msm._bases_width(group)
    pts = torch.zeros((q, M, width), dtype=torch.int32)
    bit_idx = torch.zeros((q, mb), dtype=torch.int32)
    full_idx = torch.zeros((q, mf), dtype=torch.int32)
    host = []
    for qi, (nb, nf) in enumerate(zip(nbits, nfulls)):
        bp = [mul(gen, rng.randrange(1, FR_MOD)) for _ in range(nb)]
        fp = [mul(gen, rng.randrange(1, FR_MOD)) for _ in range(nf)]
        if nb:
            pts[qi, :nb] = msm.affine_bases_plain(
                group, curve.points_to_device(group, bp, "cpu"), 1, 0)
        if nf:
            pts[qi, mb:mb + nf * bitsum.FULL_BITS] = msm.affine_bases_plain(
                group, curve.points_to_device(group, fp, "cpu"), bitsum.FULL_BITS, 1, True)
        bit_idx[qi, :nb] = torch.arange(1, nb + 1)
        full_idx[qi, :nf] = torch.arange(nb + 1, nb + nf + 1)
        host.append((bp, fp))
    counts = torch.tensor([[b, f] for b, f in zip(nbits, nfulls)], dtype=torch.int32)
    return pts, bit_idx, full_idx, counts, host, nw


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_bitsum_plain_matches_ref_ints(group):
    """Plain K5 on a two-query (G1) or one-query (G2) plan with padding in
    both blocks, for B = 3 witnesses: random values, all zero, and every
    bit set (bit wires 1, full wires 2^254 - 1)."""
    nbits, nfulls = ((3, 1), (2, 1)) if group == "g1" else ((2,), (1,))
    mb, mf = max(nbits) + 1, max(nfulls) + 1
    M = mb + mf * bitsum.FULL_BITS + 5
    pts, bidx, fidx, counts, host, nw = _synthetic_group(group, nbits, nfulls, mb, mf, M, 5)
    rng = random.Random(9)
    full_max = (1 << bitsum.FULL_BITS) - 1
    ws = [[1] + [rng.randrange(2) for _ in range(nw - 1)],
          [0] * nw,
          [1] * nw]
    for qi, nb in enumerate(nbits):  # full wires' values
        for j in range(nfulls[qi]):
            ws[0][nb + 1 + j] = rng.randrange(FR_MOD)
            ws[2][nb + 1 + j] = full_max
    W = torch.from_numpy(np.stack([tl.ints_to_limbs(w) for w in ws]))
    got = bitsum.bitsum_plain(group, pts, bidx, fidx, counts, W)
    mul, add = (g1_mul, g1_add) if group == "g1" else (g2_mul, g2_add)
    name = curve.ops_for(group).name
    for qi, (bp, fp) in enumerate(host):
        nb = len(bp)
        for b, w in enumerate(ws):
            want = None
            for i, p in enumerate(bp):
                if w[1 + i]:
                    want = add(want, p)
            for j, p in enumerate(fp):
                want = add(want, mul(p, w[nb + 1 + j] % FR_MOD))
            assert curve.to_affine_host(name, tuple(c[qi, b] for c in got)) == want, (qi, b)


@pytest.fixture(scope="module")
def planned_proof(keyed):
    """The port's planned proof of bit_cs for r = 99, s = 77."""
    return tg.prove(keyed[3], _witness(), r=99, s=77)


def _spy_bitsum(monkeypatch):
    calls = []
    real = bitsum.bitsum_msm
    monkeypatch.setattr(bitsum, "bitsum_msm", lambda *a, **k: calls.append(a[0]) or real(*a, **k))
    return calls


def test_planned_proof_equals_plain(keyed, planned_proof, monkeypatch):
    """bit_cs, r = 99, s = 77: the planned proof (K5 on both groups) equals
    the plain proof (POB_NO_PLAN=1: no K5 call) bit for bit and verifies; a
    tampered public fails."""
    _, _, _, tpk, tvk, _ = keyed
    calls = _spy_bitsum(monkeypatch)
    monkeypatch.delenv("POB_NO_PLAN", raising=False)
    W = _witness()[None]
    sums = tg.msm_stage(tpk, W, tg.compute_h(tpk.k, tpk.mats, W))
    assert calls == ["g1", "g2"] and all(s is not None for s in sums)
    monkeypatch.setenv("POB_NO_PLAN", "1")
    plain = tg.prove(tpk, _witness(), r=99, s=77)
    assert calls == ["g1", "g2"]
    assert planned_proof == plain
    assert tg.verify(tvk, planned_proof, [X])
    assert not tg.verify(tvk, planned_proof, [X + 1])


def test_plan_cache_roundtrips_with_jax(keyed, planned_proof):
    """The port's plan file is read by pob_tpu's attach_msm_plan as the
    same plan (index arrays equal, points the same group elements), and
    pob_tpu's file is read by the port as its own plan, whose proof equals
    the one from the plan it built."""
    cs, pk, vk, tpk, _, d = keyed
    ours = str(d / "port_plan.npz")
    tpk2, _ = tg.load_pk(str(d / "pk.npz"), device="cpu")
    tg.attach_msm_plan(tpk2, cs, cache_path=ours)
    for group in ("g1", "g2"):
        a, b = getattr(tpk2.plan, group), getattr(tpk.plan, group)
        for x, y in ((a.pts, b.pts), (a.bit_idx, b.bit_idx), (a.full_idx, b.full_idx),
                     (a.counts, b.counts)):
            assert torch.equal(x, y), group
    with np.load(ours) as f:
        assert sorted(f.files) == sorted(
            [f"{g}_pts{i}" for g in ("g1", "g2") for i in range(3)]
            + [f"{g}_{k}" for g in ("g1", "g2") for k in ("bit_idx", "full_idx")])
        assert f["g1_pts0"].dtype == np.uint32 and f["g1_bit_idx"].dtype == np.int32
    jpk, _ = jg.load_pk(str(d / "pk.npz"))
    jg.attach_msm_plan(jpk, cs, cache_path=ours)  # the file exists: pob_tpu reads it
    _same_plan_as_jax(tpk.plan, _jax_plan(jpk))
    for group in ("g1", "g2"):  # the same arrays' shapes as pob_tpu's own file
        for got, want in zip(_jax_plan(jpk)[group][0], _jax_plan(pk)[group][0]):
            assert got.shape == want.shape and got.dtype == want.dtype

    theirs = str(d / "jax_plan.npz")
    jpk2, _ = jg.load_pk(str(d / "pk.npz"))
    jg.attach_msm_plan(jpk2, cs, cache_path=theirs)
    tpk3, _ = tg.load_pk(str(d / "pk.npz"), device="cpu")
    tg.attach_msm_plan(tpk3, cs, cache_path=theirs)
    for group in ("g1", "g2"):
        a, b = getattr(tpk3.plan, group), getattr(tpk.plan, group)
        assert torch.equal(a.pts, b.pts) and torch.equal(a.counts, b.counts), group
    assert tg.prove(tpk3, _witness(), r=99, s=77) == planned_proof


@pytest.mark.parametrize("env,planned", [(None, True), ("0", True), ("false", True),
                                         ("", True), ("1", False), ("true", False),
                                         (" TRUE ", False)])
def test_pob_no_plan_selects_the_path(monkeypatch, env, planned):
    """POB_NO_PLAN parsed as pob_tpu's prove_batch does: 1 / true (any
    case, spaces stripped) takes the plain path; a key without a plan always
    does. (uses_plan reads only the key's plan.)"""
    if env is None:
        monkeypatch.delenv("POB_NO_PLAN", raising=False)
    else:
        monkeypatch.setenv("POB_NO_PLAN", env)
    assert tg.uses_plan(SimpleNamespace(plan=object())) is planned
    assert not tg.uses_plan(SimpleNamespace(plan=None))


def test_setup_plan_flag_and_saved_keys(tmp_path):
    """setup(plan=False) leaves the plan unset and setup() attaches it (the
    default, as pob_tpu's), timing it; save_pk / load_pk do not carry it."""
    cs = toy_cs()
    tpk, tvk = tg.setup(cs, rng=iter(SEED_SCALARS).__next__, plan=False, device="cpu")
    assert tpk.plan is None
    tg.save_pk(str(tmp_path / "k.npz"), tpk, tvk)
    assert tg.load_pk(str(tmp_path / "k.npz"), device="cpu")[0].plan is None
    tm = {}
    tpk2, _ = tg.setup(cs, rng=iter(SEED_SCALARS).__next__, device="cpu", timings=tm)
    assert isinstance(tpk2.plan, tg.MsmPlan) and tm["plan_s"] > 0
    assert tpk2.plan.nbytes() == sum(t.numel() * 4 for g in (tpk2.plan.g1, tpk2.plan.g2)
                                     for t in (g.pts, g.bit_idx, g.full_idx, g.counts))
