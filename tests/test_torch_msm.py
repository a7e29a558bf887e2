"""Host-side helpers of K3 (pob_tpu_torch.prover.msm) on the CPU: the plain
versions of its to_affine and layout kernels against python ints and the
curve reference, the level plan and scratch sizes, and the kernels' index
math (hist, scatter, bucket-sum levels, window sum, Horner) replayed with
ints mod r standing in for points. Tolerance 0."""

import bisect
import itertools
import math

import numpy as np
import pytest
import torch

from pob_tpu_torch.field import limb
from pob_tpu_torch.field.ref import FQ_MOD, FR_MOD, G1_GEN, G2_GEN, g1_mul, g2_mul
from pob_tpu_torch.prover import curve, msm

torch.set_num_threads(1)

_R_INV = pow(1 << 256, FQ_MOD - 2, FQ_MOD)


def _scalars(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]


def _words_to_ints(words) -> list:
    """(..., 8) packed words -> python ints, out of Montgomery form."""
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    return [sum(int(v) << (32 * j) for j, v in enumerate(row)) * _R_INV % FQ_MOD
            for row in w.reshape(-1, 8)]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_affine_bases_plain_vs_host(group):
    """Jacobian points with Z != 1 (sums P + Q) and infinity -> the shifted
    bases table: row w m + i holds the packed affine words of 2^(8w) P_i,
    equal to the host reference; infinity -> (0, 0)."""
    gen, mul = (G1_GEN, g1_mul) if group == "g1" else (G2_GEN, g2_mul)
    ops = curve.ops_for(group)
    host = [mul(gen, k) for k in _scalars(6, 7)]
    p = curve.points_to_device(group, host[:3] + [None], "cpu")
    q = curve.points_to_device(group, host[3:] + [None], "cpu")
    pts = curve.point_add(ops, p, q)
    m = 4
    aff = curve.to_affine_host_batch(ops.name, pts)
    got = msm.affine_bases_plain(group, pts)
    assert got.dtype == torch.int32 and got.shape == (32 * m, limb.L * (1 if group == "g1" else 2))
    vals = _words_to_ints(got)
    per = len(vals) // (32 * m)
    for w in (0, 1, 31):
        for i, a in enumerate(aff):
            row = vals[(w * m + i) * per:(w * m + i + 1) * per]
            want = None if a is None else mul(a, pow(2, 8 * w, FR_MOD))
            if want is None:
                assert row == [0] * per
            elif group == "g1":
                assert tuple(row) == want
            else:
                assert ((row[0], row[1]), (row[2], row[3])) == want


def test_pack_words_vs_ints():
    xs = [0, 1, FQ_MOD - 1, (1 << 256) - 1, 0x8000_0000 << 32]
    words = msm.pack_words(torch.from_numpy(limb.ints_to_limbs(xs)))
    assert words.dtype == torch.int32
    for x, row in zip(xs, words.numpy().astype(np.int64) & 0xFFFFFFFF):
        assert sum(int(v) << (32 * j) for j, v in enumerate(row)) == x


@pytest.mark.parametrize("n,levels", [(1, 1), (32, 1), (33, 2), (256, 2), (2048, 3),
                                      (32 * 156_870, 7), (32 << 18, 7), (32 * 3_962_976, 9),
                                      (32 << 22, 9)])
def test_level_segs(n, levels):
    segs = msm.level_segs(n)
    assert len(segs) == levels
    assert math.prod(segs) >= n and (len(segs) == 1 or math.prod(segs[:-1]) < n)


def test_k3_level_limit_covers_the_pob_key():
    """K3's bucket-sum level plan for the keys it must hold: a key of more
    than 2^21 points needs 9 levels (the PoB key at domain 2^22: 3,962,976
    wires, 2^22 h points), and 9 levels hold keys up to 2^24 points, with
    every level's divisor below 2^31 (the layout kernel's int). The
    library's own limit (csrc/msm.cuh, reported by pob_msm_max_levels) is
    held against the PoB key's plan on the card, in test_torch_cuda.py."""
    for m in (3_962_976, 1 << 22, 1 << 24):
        segs = msm.level_segs(32 * m)
        assert len(segs) == 9
        assert math.prod(segs) < 1 << 31
    assert len(msm.level_segs(32 * (1 << 21))) == 8
    assert len(msm.level_segs(32 * ((1 << 21) + 1))) == 9
    assert len(msm.level_segs(32 * ((1 << 24) + 1))) == 10


def test_segment_layout_plain_vs_ints_and_caps():
    """P[l, k] = sum_{k' < k} ceil(c_k' / D_l); the last level holds at most
    one partial per bucket; every level's total stays within level_caps."""
    B, m = 2, 3000
    rng = np.random.default_rng(3)
    n_keys = B * msm.N_BUCKETS
    counts = np.zeros(n_keys, np.int64)
    for b in range(B):  # at most 32 m digits per proof
        counts[b * 256 + rng.integers(2, 256, 20)] = rng.integers(1, 31 * m // 20, 20)
    counts[1] = m  # the bit witnesses' hot bucket: digit 1
    segs = msm.level_segs(32 * m)
    P = msm.segment_layout_plain(torch.from_numpy(counts).to(torch.int32), segs)
    assert P.shape == (len(segs) + 1, n_keys + 1) and P.dtype == torch.int32
    d = 1
    for l in range(len(segs) + 1):
        v = [(int(c) + d - 1) // d for c in counts]
        assert P[l].tolist() == [0, *itertools.accumulate(v)]
        if l < len(segs):
            d *= segs[l]
    assert int((P[-1, 1:] - P[-1, :-1]).max()) == 1
    caps = msm.level_caps(B, m, segs)
    # extremes of a batch of m scalars: every digit of a proof in one
    # bucket, or spread over all 255
    hot = torch.zeros(B, msm.N_BUCKETS, dtype=torch.int32)
    hot[:, 1] = 32 * m
    spread = torch.zeros_like(hot)
    spread[:, 1:] = 32 * m // 255
    spread[:, 1] += 32 * m % 255
    for c in (counts, hot.flatten().numpy(), spread.flatten().numpy()):
        P = msm.segment_layout_plain(torch.from_numpy(c).to(torch.int32), segs)
        assert all(int(P[l, -1]) <= caps[l] for l in range(len(segs) + 1))


def _replay_k3(points, scalars):
    """K3's kernels step by step (csrc/msm.cuh) on ints mod r as points."""
    B, m = len(scalars), len(points)
    table = [p * pow(256, w, FR_MOD) % FR_MOD for w in range(32) for p in points]
    n_keys, chunks = B * 256, -(-m // msm.HIST_CHUNK)
    blocks = [(b, range(c * msm.HIST_CHUNK, min(m, (c + 1) * msm.HIST_CHUNK)))
              for b in range(B) for c in range(chunks)]
    blockhist, counts = [], [0] * n_keys
    for b, rows in blocks:  # hist
        h = [0] * 256
        for i in rows:
            for w in range(32):
                h[(scalars[b][i] >> (8 * w)) & 0xFF] += 1
        h[0] = 0
        blockhist.append(h)
        for d in range(256):
            counts[b * 256 + d] += h[d]
    segs = msm.level_segs(32 * m)
    caps = msm.level_caps(B, m, segs)
    P = msm.segment_layout_plain(torch.tensor(counts, dtype=torch.int32), segs).tolist()
    cursor, idx = list(P[0][:n_keys]), [None] * caps[0]
    for (b, rows), h in zip(blocks, blockhist):  # scatter
        runs = [[] for _ in range(256)]
        for i in rows:
            for w in range(32):
                runs[(scalars[b][i] >> (8 * w)) & 0xFF].append(w * m + i)
        for d in range(1, 256):
            assert len(runs[d]) == h[d]
            idx[cursor[b * 256 + d]:cursor[b * 256 + d] + h[d]] = runs[d]
            cursor[b * 256 + d] += h[d]
    src = None
    for level, seg in enumerate(segs):  # bucket sums
        Pin, Pout = P[level], P[level + 1]
        out = []
        for g in range(Pout[n_keys]):
            key = bisect.bisect_right(Pout, g, 0, n_keys) - 1
            start = Pin[key] + (g - Pout[key]) * seg
            items = range(start, min(start + seg, Pin[key + 1]))
            out.append(sum(table[idx[e]] if level == 0 else src[e] for e in items))
        assert len(out) <= caps[level + 1]
        src = out
    PL, out = P[-1], []
    for b in range(B):  # reduce: 32 threads of 8 buckets
        bucket = [src[PL[b * 256 + d]] if PL[b * 256 + d + 1] > PL[b * 256 + d] else 0
                  for d in range(256)]
        lw = [sum(j * bucket[8 * c + j] for j in range(8)) for c in range(32)]
        tot = [sum(bucket[8 * c:8 * c + 8]) for c in range(32)]
        suffix = [sum(tot[c:]) for c in range(32)]
        out.append((sum(lw) + 8 * sum(suffix[1:])) % FR_MOD)
    return out, len(segs)


@pytest.mark.parametrize("case", ["edges", "ones"])
def test_k3_index_math_replayed_with_ints(case):
    """Digit boundaries 0x7F, 0x80, 0xFF and r - 1 in several windows; and
    an all-ones batch (one bucket of m entries, 3 bucket-sum levels)."""
    rng = np.random.default_rng(5)
    if case == "edges":
        m, vals = 300, [0, 0x7F, 0x80, 0xFF, FR_MOD - 1, 0xFF << 8, 0x80 << 128, 0x7F << 240]
        scalars = [[vals[j] for j in rng.integers(0, len(vals), m)] for _ in range(2)]
    else:
        m = 2048
        scalars = [[1] * m]
    points = _scalars(m, 6)
    got, levels = _replay_k3(points, scalars)
    assert got == [sum(s * p for s, p in zip(row, points)) % FR_MOD for row in scalars]
    assert levels == len(msm.level_segs(32 * m))
