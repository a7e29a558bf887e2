"""Kernels K1-K4 against their plain PyTorch versions on the card, and the
toy Groth16 slice on the card against the CPU. Marked `cuda`: skipped
without a GPU. On a GPU machine without jax:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from pob_tpu_torch import _build
from pob_tpu_torch.field import cuda_mont, limb
from pob_tpu_torch.field.ref import FR_MOD, G1_GEN, G2_GEN, g1_add, g1_mul, g2_add, g2_mul
from pob_tpu_torch.prover import curve, msm, ntt
from pob_tpu_torch.r1cs.builder import ConstraintSystem

pytestmark = pytest.mark.cuda


def curve_ref_add(group):
    return g1_add if group == "g1" else g2_add


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _elems(shape, seed):
    x = np.random.default_rng(seed).integers(0, 1 << 16, size=tuple(shape) + (16,))
    x[..., 15] %= 0x3000
    return torch.from_numpy(x.astype(np.int32))


@pytest.mark.parametrize("spec", [limb.FR, limb.FQ], ids=["fr", "fq"])
def test_k1_matches_plain(dev, spec):
    a, b = _elems((4099,), 1).to(dev), _elems((4099,), 2).to(dev)
    a[:3] = limb.to_device(limb.ints_to_limbs([0, 1, spec.mod - 1]), dev)
    wide = torch.cat([a, b], -1)
    for op, args, plain in (
        (cuda_mont.MUL, (a, b), limb.mont_mul_plain(spec, a, b)),
        (cuda_mont.SQR, (a,), limb.mont_mul_plain(spec, a, a)),
        (cuda_mont.ADD, (a, b), limb.add_plain(spec, a, b)),
        (cuda_mont.SUB, (a, b), limb.sub_plain(spec, a, b)),
        (cuda_mont.REDC, (wide,), limb.mont_reduce_plain(spec, wide)),
    ):
        assert torch.equal(cuda_mont.field_op(op, spec, *args), plain), op


def test_k2_matches_plain(dev):
    k = 10
    x = _elems((3, 1 << k), 3).to(dev)
    br = x.index_select(-2, torch.from_numpy(ntt._bitrev(k)).to(dev))
    roots = limb.to_device(ntt._root_powers(k, False), dev)
    assert torch.equal(ntt.ntt_stages_cuda(br, k, roots), ntt._transform_plain(br, k, roots))
    back = ntt.intt(ntt.ntt(x, k), k)
    assert torch.equal(back, x)


@pytest.mark.parametrize("group,m", [("g1", 200), ("g2", 40)])
def test_k3_k4_match_plain(dev, group, m):
    ops = curve.ops_for(group)
    sc = _elems((m,), 4).to(dev)
    sc[:2] = 0
    pts = msm.fixed_base_msm(group, sc)
    aff = curve.to_affine_host_batch(ops.name, pts)
    assert aff == curve.to_affine_host_batch(ops.name, msm.fixed_base_plain(group, sc))
    gen, mul = (G1_GEN, g1_mul) if group == "g1" else (G2_GEN, g2_mul)
    k = limb.limb_rows_to_ints(sc[:4].cpu().numpy())
    assert aff[:4] == [mul(gen, s) if s else None for s in k]
    ssc = _elems((2, m), 5).to(dev)
    got = msm.msm_batched(group, pts, ssc)
    want = msm.msm_plain(ops, pts, ssc)
    assert curve.to_affine_host_batch(ops.name, got) == curve.to_affine_host_batch(ops.name, want)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k4_table_matches_plain(dev, group):
    """K4's table kernels against their plain version on all 8192 entries."""
    msm.window_table.cache_clear()
    table = msm.window_table(group, str(dev))
    assert torch.equal(table, msm.fixed_base_table_plain(group, dev))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k4_edge_scalars(dev, group):
    """0, 1, r - 1, the largest top digit 0x30 << 248, a scalar whose only
    nonzero digit is in window 31, an all-zero batch and m = 1."""
    vals = [0, 1, FR_MOD - 1, 0x30 << 248, 0x17 << 248, 0xFF, 0x80 << 128]
    gen, mul = (G1_GEN, g1_mul) if group == "g1" else (G2_GEN, g2_mul)
    sc = torch.cat([limb.to_device(limb.ints_to_limbs(vals), dev), _elems((100,), 10).to(dev)])
    got = msm.fixed_base_msm(group, sc)
    assert _same(group, got, msm.fixed_base_plain(group, sc))
    assert curve.to_affine_host_batch(curve.ops_for(group).name, tuple(c[:len(vals)]
                                                                      for c in got)) == [
        mul(gen, s) if s else None for s in vals]
    for few in (torch.zeros_like(sc[:64]), sc[3:4]):
        assert _same(group, msm.fixed_base_msm(group, few), msm.fixed_base_plain(group, few))


@pytest.mark.parametrize("k", [5, 11, 13])
def test_k2_passes_match_plain(dev, k):
    """Below one tile (k = 5) and with two unevenly split passes (11, 13),
    from bit-reversed input and with the gather folded in."""
    x = _elems((3, 1 << k), 30 + k).to(dev)
    br = x.index_select(-2, torch.from_numpy(ntt._bitrev(k)).to(dev))
    roots = limb.to_device(ntt._root_powers(k, True), dev)
    want = ntt._transform_plain(br, k, roots)
    assert torch.equal(ntt.ntt_stages_cuda(br, k, roots), want)
    assert torch.equal(ntt.ntt_stages_cuda(x, k, roots, gather=True), want)


def _same(group, p, q):
    return bool(curve.points_equal(curve.ops_for(group), p, q).all())


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k3_skewed_batch(dev, group):
    """All scalars 1: one bucket of m = 2048 entries, 3 bucket-sum levels."""
    m = 2048
    assert len(msm.level_segs(m)) >= 3
    pts = msm.fixed_base_msm(group, _elems((m,), 6).to(dev))
    sc = limb.to_device(limb.ints_to_limbs([1] * (2 * m)), dev).reshape(2, m, 16)
    assert _same(group, msm.msm_batched(group, pts, sc),
                 msm.msm_plain(curve.ops_for(group), pts, sc))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k3_digit_boundaries(dev, group):
    """Digits 0x7F, 0x80, 0xFF (the bucket edges) in low, middle and high
    windows, and r - 1."""
    vals = [0x7F, 0x80, 0xFF, FR_MOD - 1, 0x7F << 240, 0x80 << 120, 0xFF << 8,
            int("80" * 31, 16), int("FF" * 31, 16)]
    pts = msm.fixed_base_msm(group, _elems((len(vals),), 7).to(dev))
    sc = limb.to_device(limb.ints_to_limbs(vals + vals[::-1]), dev).reshape(2, len(vals), 16)
    got = msm.msm_batched(group, pts, sc)
    assert _same(group, got, msm.msm_plain(curve.ops_for(group), pts, sc))
    gen, mul = (G1_GEN, g1_mul) if group == "g1" else (G2_GEN, g2_mul)
    ks = limb.limb_rows_to_ints(_elems((len(vals),), 7).numpy())
    want = None
    add = curve_ref_add(group)
    for s, k in zip(vals, ks):
        want = add(want, mul(gen, s * k % FR_MOD))
    assert curve.to_affine_host(curve.ops_for(group).name, tuple(c[0] for c in got)) == want


def test_k3_layout_and_affine_kernels_match_plain(dev):
    lib = _build.lib("msm_g1.cu")
    counts = torch.from_numpy(np.random.default_rng(8).integers(0, 3000, 2 * 256)
                              .astype(np.int32)).to(dev)
    segs = msm.level_segs(32 * 3000)
    P, cursor = msm._layout_cuda(lib, counts, segs, _build.stream_ptr(counts))
    want = msm.segment_layout_plain(counts, segs)
    assert torch.equal(P, want) and torch.equal(cursor, want[0, :-1])
    for group in ("g1", "g2"):
        ops = curve.ops_for(group)
        pts = msm.fixed_base_msm(group, _elems((50,), 9).to(dev))
        pts = curve.point_add(ops, pts, tuple(c.roll(1, 0) for c in pts))  # Z != 1
        pts[2][3] = 0  # infinity -> (0, 0)
        assert torch.equal(msm.affine_bases(group, pts), msm.affine_bases_plain(group, pts))


def test_toy_slice_on_card_equals_cpu(dev):
    from pob_tpu_torch.prover import groth16

    cs = ConstraintSystem()
    z1, z2 = cs.alloc_block("pub", (2,))
    cs.mark_public(2)
    x, y = cs.alloc_block("priv", (2,))
    cs.add([(x, 1)], [(y, 1)], [(z1, 1)])
    cs.add([(x, 1), (y, 1)], [(x, 1)], [(z2, 1)])
    ws = [[1, a * b % FR_MOD, (a + b) * a % FR_MOD, a, b] for a, b in ((3, 5), (7, 11))]
    W = torch.from_numpy(limb.ints_to_limbs([v for w in ws for v in w]).reshape(2, 5, 16))
    rs = [(5, 6), (7, 8)]
    out = {}
    for d in (dev, torch.device("cpu")):
        pk, vk = groth16.setup(cs, rng=iter(range(101, 200, 7)).__next__, device=d)
        out[d.type] = groth16.prove_batch(pk, W.to(d), rs=rs)
    assert out["cuda"] == out["cpu"]
    assert groth16.verify(vk, out["cuda"][0], ws[0][1:3])


def test_inv_mont_on_card_matches_plain(dev):
    x = _elems((257,), 12)
    x[:2] = limb.to_device(limb.ints_to_limbs([0, 1]), "cpu")
    for spec in (limb.FR, limb.FQ):
        assert torch.equal(limb.inv_mont(spec, x.to(dev)).cpu(), limb.inv_mont(spec, x))


def test_k2_k22_matches_plain(dev):
    """Three K2 passes (0, 10, 0), (10, 10, 0), (20, 2, 8): the PoB domain."""
    k = 22
    x = _elems((1, 1 << k), 13).to(dev)
    roots = limb.to_device(ntt._root_powers(k, False), dev)
    br = x.index_select(-2, torch.from_numpy(ntt._bitrev(k)).to(dev))
    assert len(ntt.ntt_passes(k)) == 3
    assert torch.equal(ntt.ntt_stages_cuda(x, k, roots, gather=True),
                       ntt._transform_plain(br, k, roots))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k3_max_levels_covers_the_pob_key(dev, group):
    """K3's library reports its level limit; the PoB key (2^22 h points)
    needs every one of its 9 levels, and 2^24 points still fit."""
    limit = _build.lib(msm._MSM_SRC[group]).pob_msm_max_levels()
    assert len(msm.level_segs(32 * (1 << 24))) <= limit
    assert len(msm.level_segs(32 * (1 << 22))) <= limit


def test_pob_witness_on_card_equals_cpu(dev):
    """pob_r1cs_witness at PoBConfig(2, 3, 5, ...) on the fixture cut to its
    two used layers, batch 2 (the fixture, and layer 1 corrupted): every
    block on the card equals the CPU's."""
    import json
    import os

    from pob_tpu_torch.circuits.proof_of_burn import PoBConfig
    from pob_tpu_torch.harness import inputs
    from pob_tpu_torch.r1cs.pob_circuit import pob_r1cs_witness

    cfg = PoBConfig(2, 3, 5, 20, 31, 2, 10**18, 10**19)
    with open(os.path.join(os.path.dirname(__file__), "fixtures", "pob_input.json")) as f:
        base = json.load(f)
    small = dict(base, layers=[l[:cfg.max_node_bytes] for l in base["layers"][:2]],
                 layerLens=base["layerLens"][:2])
    bad = json.loads(json.dumps(small))
    bad["layers"][1][0] ^= 0xFF
    host = inputs.batch_stack([inputs.load_pob_input(c, cfg) for c in (small, bad)])
    cpu = pob_r1cs_witness(cfg, **inputs.to_device(host, "cpu"))
    card = pob_r1cs_witness(cfg, **inputs.to_device(host, dev))
    assert set(card) == set(cpu)
    for name, v in cpu.items():
        assert torch.equal(card[name].cpu().long(), v.long()), name


def _toy_keyed(dev):
    """The toy circuit of test_toy_slice_on_card_equals_cpu, keyed on `dev`,
    and five witnesses (B, 5, 16) on it."""
    from pob_tpu_torch.prover import groth16

    cs = ConstraintSystem()
    z1, z2 = cs.alloc_block("pub", (2,))
    cs.mark_public(2)
    x, y = cs.alloc_block("priv", (2,))
    cs.add([(x, 1)], [(y, 1)], [(z1, 1)])
    cs.add([(x, 1), (y, 1)], [(x, 1)], [(z2, 1)])
    ws = [[1, a * b % FR_MOD, (a + b) * a % FR_MOD, a, b] for a, b in
          ((3, 5), (7, 11), (13, 17), (19, 23), (29, 31))]
    W = torch.from_numpy(limb.ints_to_limbs([v for w in ws for v in w]).reshape(5, 5, 16))
    pk, vk = groth16.setup(cs, rng=iter(range(101, 200, 7)).__next__, device=dev)
    return cs, pk, vk, W.to(dev), [w[1:3] for w in ws]


def test_zkey_points_from_bases_equal_plain(dev, tmp_path):
    """write_zkey on the card writes window 0 of the key's affine bases (K3's
    shifted-bases kernel); without bases it writes the plain
    msm._packed_affine of the Jacobian points: the files are equal."""
    import dataclasses

    from pob_tpu_torch.prover import serialize

    cs, pk, vk, _, _ = _toy_keyed(dev)
    serialize.write_zkey(str(tmp_path / "bases.zkey"), pk, vk, cs)
    serialize.write_zkey(str(tmp_path / "plain.zkey"), dataclasses.replace(pk, bases=None), vk,
                         cs)
    assert (tmp_path / "bases.zkey").read_bytes() == (tmp_path / "plain.zkey").read_bytes()


def test_load_zkey_on_card_proves_like_original(dev, tmp_path):
    from pob_tpu_torch.prover import groth16, serialize

    cs, pk, vk, W, pubs = _toy_keyed(dev)
    serialize.write_zkey(str(tmp_path / "k.zkey"), pk, vk, cs)
    lpk, lvk = groth16.load_zkey(str(tmp_path / "k.zkey"), dev)
    assert lpk.bases is not None and lvk.ic == vk.ic
    rs = [(5 + i, 6 + i) for i in range(5)]
    got = groth16.prove_batch(lpk, W, rs=rs)
    assert got == groth16.prove_batch(pk, W, rs=rs)
    assert all(groth16.verify(lvk, p, x) for p, x in zip(got, pubs))
    assert groth16.prove(lpk, W[2], r=7, s=8) == got[2]


def test_prove_batch_in_chunks_on_card(dev, monkeypatch):
    from pob_tpu_torch.prover import groth16

    _, pk, _, W, _ = _toy_keyed(dev)
    assert groth16.batch_chunk(pk, 5, W.device) == 5
    rs = [(5 + i, 6 + i) for i in range(5)]
    whole = groth16.prove_batch(pk, W, rs=rs)
    monkeypatch.setattr(groth16, "batch_chunk", lambda pk, B, device: 2)
    tm = {}
    assert groth16.prove_batch(pk, W, rs=rs, timings=tm) == whole and tm["chunk"] == 2


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("windows,dbl,wire_major", [(32, 8, False), (254, 1, True), (1, 0, False)])
def test_k6_matches_plain(dev, group, windows, dbl, wire_major, monkeypatch):
    """K6 (the shifted-bases kernel) at K3's bases (32, 8), the plan's
    chains (254, 1, wire-major) and a plain conversion (1, 0): the same
    words as its plain version, on points with Z != 1 and an infinity; and
    over several blocks, with a whole warp of infinite inputs and an
    infinite input between finite ones, in one launch and in launches of
    100 points (a scratch that small)."""
    ops = curve.ops_for(group)
    per_point = windows * msm._bases_width(group) * 2  # scratch bytes
    for m, infinite in ((24, [5]), (300, list(range(64, 96)) + [150])):
        pts = msm.fixed_base_msm(group, _elems((m,), 40 + m).to(dev))
        pts = curve.point_add(ops, pts, tuple(c.roll(1, 0) for c in pts))  # Z != 1
        pts[2][infinite] = 0
        want = msm.affine_bases_plain(group, pts, windows, dbl, wire_major)
        for scratch in (msm.K6_SCRATCH_BYTES, 100 * per_point):
            monkeypatch.setattr(msm, "K6_SCRATCH_BYTES", scratch)
            before = _build.LAUNCHES["chains"]
            got = msm.affine_bases(group, pts, windows, dbl, wire_major)
            assert _build.LAUNCHES["chains"] == before + -(-m // min(m, scratch // per_point))
            assert torch.equal(got, want), (m, scratch)


def _k5_case(dev, group, q, nbs, nfs, mb, mf, M, B, seed, fill=None):
    """A plan group on the card over random points k G: query i has nbs[i]
    bit points and nfs[i] full wires (doubling chains by K6), padded to mb,
    mf and M, its wires drawn from [1, nw); and B witnesses: random (bit
    wires 0 or 1, full wires random), every limb `fill`, "sparse" (each bit
    set with probability 1/64) or "one" (a single set bit in proof 0, a bit
    wire of query 0, and one in proof B - 1, a full wire of query q - 1)."""
    from pob_tpu_torch.prover import bitsum

    rng = np.random.default_rng(seed)
    nw = 4 * (mb + mf) + 8
    width = msm._bases_width(group)
    pts = torch.zeros((q, M, width), dtype=torch.int32, device=dev)
    bit_idx = torch.zeros((q, mb), dtype=torch.int32)
    full_idx = torch.zeros((q, mf), dtype=torch.int32)
    for i in range(q):
        wires = rng.permutation(np.arange(1, nw))[:nbs[i] + nfs[i]]
        bit_idx[i, :nbs[i]] = torch.from_numpy(wires[:nbs[i]].astype(np.int32))
        full_idx[i, :nfs[i]] = torch.from_numpy(wires[nbs[i]:].astype(np.int32))
        p = msm.fixed_base_msm(group, _elems((nbs[i] + nfs[i],), seed + i).to(dev))
        pts[i, :nbs[i]] = msm.affine_bases(group, tuple(c[:nbs[i]] for c in p), 1, 0)
        pts[i, mb:mb + nfs[i] * bitsum.FULL_BITS] = msm.affine_bases(
            group, tuple(c[nbs[i]:] for c in p), bitsum.FULL_BITS, 1, True)
    if fill is None or fill == "sparse":
        W = _elems((B, nw), seed + 99)
        if fill == "sparse":
            bits = torch.from_numpy(rng.random((B, nw, 16, 16)) < 1 / 64)
            W = (bits.to(torch.int32) << torch.arange(16, dtype=torch.int32)).sum(-1)
            W = W.to(torch.int32)
        W[..., :, 1:][:, bit_idx.flatten().long()] = 0
        W[:, bit_idx.flatten().long(), 0] &= 1
    elif fill == "one":
        W = torch.zeros((B, nw, 16), dtype=torch.int32)
        W[0, bit_idx[0, 7], 0] = 1
        W[B - 1, full_idx[q - 1, 1], 200 >> 4] = 1 << (200 & 15)
    else:
        W = torch.full((B, nw, 16), fill, dtype=torch.int32)
    counts = torch.tensor(list(zip(nbs, nfs)), dtype=torch.int32)
    return pts, bit_idx.to(dev), full_idx.to(dev), counts.to(dev), W.to(dev)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("B", [1, 16])
def test_k5_matches_plain(dev, group, B):
    """K5 against its plain version: M below one run and M not a multiple
    of the run, both blocks padded (queries of different counts, wire 0 in
    the padding, whose value 1 must not count), random, all-zero, all-one,
    sparse (1 bit in 64) witnesses and a single set bit."""
    from pob_tpu_torch.prover import bitsum

    q = 3 if group == "g1" else 1
    for nbs, nfs, mb, mf, M in ((250, 5, 300, 7, 300 + 7 * 254 + 37),
                                (8000, 20, 8100, 20, 3 * 4096 + 1000)):
        nbs, nfs = [nbs - 17 * i for i in range(q)], [nfs - i for i in range(q)]
        assert M % bitsum_run(group, q, B, M) and mb + mf * bitsum.FULL_BITS <= M
        for fill in (None, 0, 0xFFFF, "sparse", "one"):
            args = _k5_case(dev, group, q, nbs, nfs, mb, mf, M, B, 50 + M, fill)
            before = _build.LAUNCHES[f"bitsum_{group}"]
            got = bitsum.bitsum_msm(group, *args)
            assert _build.LAUNCHES[f"bitsum_{group}"] == before + 2
            want = bitsum.bitsum_plain(group, *args)
            for g, w in zip(got, want):
                assert tuple(g.shape) == (q, B) + curve.ops_for(group).coord_shape
            assert _same(group, tuple(c.flatten(0, 1) for c in got),
                         tuple(c.flatten(0, 1) for c in want)), (M, fill)


def bitsum_run(group, q, B, M):
    """Positions per warp of K5's sweep for this call on this card."""
    from pob_tpu_torch.prover import bitsum

    return bitsum.sweep_run(q, B, M, _build.lib(bitsum._SRC[group]).pob_bitsum_warps_per_sm(),
                            torch.cuda.get_device_properties(0).multi_processor_count)


def test_planned_toy_slice_on_card(dev, monkeypatch):
    """The toy key's plan made on the card (K6 chains, bit points from the
    affine bases) equals the CPU's (K6 at (1, 0) for the bit points), and
    the card's planned proofs equal its plain ones (POB_NO_PLAN=1)."""
    from pob_tpu_torch.prover import groth16

    cs, pk, vk, W, pubs = _toy_keyed(dev)
    assert pk.plan is not None
    cpk, _ = groth16.setup(cs, rng=iter(range(101, 200, 7)).__next__, device="cpu")
    for group in ("g1", "g2"):
        a, b = getattr(pk.plan, group), getattr(cpk.plan, group)
        for x, y in ((a.pts, b.pts), (a.bit_idx, b.bit_idx), (a.full_idx, b.full_idx),
                     (a.counts, b.counts)):
            assert torch.equal(x.cpu(), y), group
    rs = [(5 + i, 6 + i) for i in range(5)]
    planned = groth16.prove_batch(pk, W, rs=rs)
    monkeypatch.setenv("POB_NO_PLAN", "1")
    assert groth16.prove_batch(pk, W, rs=rs) == planned
    assert all(groth16.verify(vk, p, x) for p, x in zip(planned, pubs))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k3_small_shards_match_plain(dev, group):
    """K3 at B = 1 over the few points a shard of a toy key holds (m = 1-8),
    infinity padding (the (0, 0) bases) and zero scalars included."""
    ops = curve.ops_for(group)
    for m in (1, 2, 3, 5, 8):
        sc = _elems((m,), 20 + m).to(dev)
        pts = tuple(c.clone() for c in msm.fixed_base_msm(group, sc))
        pts[2][-1] = 0  # the last point at infinity
        ssc = _elems((1, m), 30 + m).to(dev)
        ssc[0, 0] = 0
        got = msm.msm_batched(group, pts, ssc)
        want = msm.msm_plain(ops, pts, ssc)
        assert curve.to_affine_host_batch(ops.name, got) == curve.to_affine_host_batch(
            ops.name, want), m


@pytest.mark.parametrize("D", [2, 4])
def test_ntt_sharded_k10_on_card(dev, D):
    """The four-step NTT at k = 10 (5 + 5) on a virtual mesh of the card, both
    ways, against the local K2 transform."""
    from pob_tpu_torch.dist.mesh import data_mesh
    from pob_tpu_torch.dist.ntt_sharded import ntt_sharded, untranspose_host

    x = _elems((1 << 10,), 40).to(dev)
    for inverse, local in ((False, ntt.ntt), (True, ntt.intt)):
        c = ntt_sharded(data_mesh(D, device=dev), x, 5, 5, inverse=inverse)
        assert all(b.is_cuda for b in c)
        np.testing.assert_array_equal(untranspose_host(c), local(x, 10).cpu().numpy())


@pytest.mark.parametrize("group,D", [("g1", 4), ("g2", 2)])
def test_msm_sharded_on_card_matches_ref(dev, group, D):
    """msm_sharded on a virtual mesh of the card (each shard's K6 bases and
    K3, the partials gathered on the first shard and reduced by K1 point
    adds), with infinity padding (m = 7), against the g1_mul / g2_mul sum."""
    from pob_tpu_torch.dist.mesh import data_mesh
    from pob_tpu_torch.dist.msm_sharded import msm_sharded

    mul, add = (g1_mul, g1_add) if group == "g1" else (g2_mul, g2_add)
    gen = G1_GEN if group == "g1" else G2_GEN
    to_dev = curve.g1_points_to_device if group == "g1" else curve.g2_points_to_device
    m = 7
    pts = [mul(gen, 3 * i + 2) for i in range(m)]
    scalars = [(i * 7919 + 5) ** 5 % FR_MOD for i in range(m)]
    got = msm_sharded(data_mesh(D, device=dev), to_dev(pts, dev),
                      limb.to_device(limb.ints_to_limbs(scalars), dev))
    assert all(c.is_cuda for c in got)
    want = None
    for sc, p in zip(scalars, pts):
        want = add(want, mul(p, sc))
    assert curve.to_affine_host("fq" if group == "g1" else "fq2", got) == want


def test_prove_sharded_on_card_equals_prove(dev):
    """prove_sharded at D = 2 on a virtual mesh of the card (shards' K6 bases,
    K3 per shard, the four-step h stage) equals prove at fixed (r, s)."""
    from pob_tpu_torch.dist.mesh import data_mesh
    from pob_tpu_torch.dist.prove_sharded import prove_sharded, shard_pk
    from pob_tpu_torch.prover import groth16

    cs, pk, vk, W, pubs = _toy_keyed(dev)
    spk = shard_pk(pk, data_mesh(2, device=dev))
    for i in range(2):
        want = groth16.prove(pk, W[i], r=1234, s=5678)
        assert prove_sharded(spk, W[i], r=1234, s=5678) == want
        assert groth16.verify(vk, want, pubs[i])


def test_pipeline_on_card_equals_prove_batch(dev):
    """Groth16Pipeline on [card] * 3 and [card] * 6 (an MSM group of 4
    shards): the streamed proofs equal prove_batch's at the same (r, s)."""
    from pob_tpu_torch.dist.pipeline import Groth16Pipeline
    from pob_tpu_torch.prover import groth16

    cs, pk, vk, W, pubs = _toy_keyed(dev)
    rs = [(5 + i, 6 + i) for i in range(5)]
    want = groth16.prove_batch(pk, W, rs=rs)
    reqs = [(i,) for i in range(5)]
    for n in (3, 6):
        pipe = Groth16Pipeline(pk, lambda i: W[i], devices=[dev] * n)
        assert pipe.prove_stream(reqs, rs) == want, n




def test_process_mesh_of_one_nccl_rank(dev):
    """init_multihost in this process as a world of one NCCL rank: data_mesh()
    is the process mesh; the four-step at k = 10 (both ways) equals the local
    K2 transform, msm_sharded (K6 bases, K3, the partials all-gathered by
    NCCL, K1 reduction) equals the local K3 call, prove_sharded equals
    prove at fixed (r, s) and verifies with r = s = None, and the pipeline
    refuses the mesh."""
    import datetime
    import socket

    import torch.distributed as dist

    from pob_tpu_torch.dist.mesh import data_mesh, gather, init_multihost
    from pob_tpu_torch.dist.msm_sharded import msm_sharded
    from pob_tpu_torch.dist.ntt_sharded import ntt_sharded, untranspose_host
    from pob_tpu_torch.dist.pipeline import Groth16Pipeline
    from pob_tpu_torch.dist.prove_sharded import prove_sharded, shard_pk
    from pob_tpu_torch.prover import groth16

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    info = init_multihost(f"127.0.0.1:{port}", 1, 0, timeout=datetime.timedelta(seconds=60))
    try:
        assert info["process_index"] == 0 and info["global_devices"] == 1
        assert dist.get_backend() == "nccl"
        mesh = data_mesh()
        assert mesh.rank == 0 and mesh.devices == (torch.device("cuda", 0),)
        x = _elems((1 << 10,), 41).to(dev)
        for inverse, local in ((False, ntt.ntt), (True, ntt.intt)):
            c = ntt_sharded(mesh, x, 5, 5, inverse=inverse)
            np.testing.assert_array_equal(untranspose_host(list(gather(mesh, c))),
                                          local(x, 10).cpu().numpy())
        for group, m in (("g1", 7), ("g2", 5)):
            ops = curve.ops_for(group)
            pts = msm.fixed_base_msm(group, _elems((m,), 42).to(dev))
            sc = _elems((m,), 43).to(dev)
            want = tuple(c[0] for c in msm.msm_batched(group, pts, sc[None]))
            assert curve.to_affine_host(ops.name, msm_sharded(mesh, pts, sc)) == \
                curve.to_affine_host(ops.name, want)
        cs, pk, vk, W, pubs = _toy_keyed(dev)
        spk = shard_pk(pk, mesh)
        assert prove_sharded(spk, W[0], r=1234, s=5678) == groth16.prove(pk, W[0], 1234, 5678)
        assert groth16.verify(vk, prove_sharded(spk, W[1]), pubs[1])
        with pytest.raises(ValueError):
            Groth16Pipeline(pk, lambda i: W[i])
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k1_point_ops_on_card_match_plain(dev, group):
    """tree_reduce with K1's field ops (curve.k1_ops_for, the sharded MSM's
    reduction) equals it with the plain ones, doubling and cancel included."""
    pts = tuple(c.clone() for c in msm.fixed_base_msm(group, _elems((7,), 50).to(dev)))
    ops = curve.ops_for(group)
    for c in pts:  # tree pairs (0, 3), (1, 4), (2, 5): P + P and Q + (-Q)
        c[3] = c[0]
    pts[0][4], pts[2][4] = pts[0][1], pts[2][1]
    pts[1][4] = ops.neg(pts[1][1])
    got = curve.tree_reduce(curve.k1_ops_for(group), pts)
    want = curve.tree_reduce(ops, pts)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("S", [1, 2, 8, 16])
def test_k3_shifted_windows_match_plain(dev, group, S):
    """K3 over bases of S shifted windows (32 / S passes, folded with 8 S
    doublings): random scalars with the digit edges at B = 2, and a skewed
    batch (every scalar 1: one bucket of m entries in pass 0, the other
    passes empty) at m = 2048, against the plain version; the launches are
    K3's five of S = 32 plus its levels and the fold."""
    ops = curve.ops_for(group)
    m = 300
    pts = msm.fixed_base_msm(group, _elems((m,), 20 + S).to(dev))
    bases = msm.affine_bases(group, pts, S)
    assert bases.shape[0] == S * m
    sc = _elems((2, m), 21).to(dev)
    edges = [0x7F, 0x80, 0xFF, FR_MOD - 1, 0x7F << 240, 0x80 << 120, 0xFF << 8, 0]
    sc[0, :len(edges)] = limb.to_device(limb.ints_to_limbs(edges), dev)
    before = _build.LAUNCHES["msm"]
    got = msm.msm_batched(group, pts, sc, bases)
    assert _build.LAUNCHES["msm"] - before == 4 + len(msm.level_segs(32 * m)) + 1
    assert _same(group, got, msm.msm_plain(ops, pts, sc))
    m_skew = 2048
    pts1 = msm.fixed_base_msm(group, _elems((m_skew,), 22).to(dev))
    sc1 = limb.to_device(limb.ints_to_limbs([1] * m_skew), dev).reshape(1, m_skew, 16)
    assert _same(group, msm.msm_batched(group, pts1, sc1, msm.affine_bases(group, pts1, S)),
                 msm.msm_plain(ops, pts1, sc1))
    with pytest.raises(ValueError):
        msm.msm_batched(group, pts, sc, bases[:-1])


def test_setup_scalars_on_card_equal_host(dev):
    """setup_scalars_dev on the card (K1 in the scans and column sums)
    equals setup_scalars' host ints on the toy circuit; the NTT tables
    made on the card equal the host tables at k = 10."""
    from pob_tpu_torch.prover import groth16

    cs, _, _, _, _ = _toy_keyed(dev)
    toxic = (1234567, 89101112, 13141516, 17181920, 21222324)
    k, host, _ = groth16.setup_scalars(cs, toxic)
    k2, card, _ = groth16.setup_scalars_dev(cs, toxic, dev)
    assert k == k2
    for q in host:
        assert card[q].is_cuda and limb.limb_rows_to_ints(card[q].cpu().numpy()) == host[q], q
    shift = ntt.domain_root(11)
    for inverse in (False, True):
        assert np.array_equal(ntt._root_powers_dev(10, inverse, dev).cpu().numpy(),
                              ntt._root_powers(10, inverse))
        assert np.array_equal(ntt._coset_powers_dev(10, shift, inverse, dev).cpu().numpy(),
                              ntt._coset_powers(10, shift, inverse))
