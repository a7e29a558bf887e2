"""The index math and the walks of K5 (csrc/bitsum.cuh) and K6
(csrc/msm.cuh's shifted-bases kernel) replayed on the CPU, step for step as
the kernels take them, against their plain versions. Tolerance 0.

K6: the doublings once, with the running product c of Z (a zero standing in
as one) folded into each output row (X c^2, Y c^3) and Z kept in the
scratch; one inversion per point; the backward walk that turns each row
affine; written with the port's plain field products (limb.mont_mul_plain
through curve.ops_for). K5: the sweep's grid, each
warp's run and its compaction (ballot mask, prefix count below the lane, a
ring of QCAP positions, pops of 32, the remainder drained), with numpy."""

import numpy as np
import pytest
import torch

from pob_tpu_torch.field import limb
from pob_tpu_torch.field.ref import FQ_MOD, FR_MOD, G1_GEN, G2_GEN, g1_mul, g2_mul
from pob_tpu_torch.prover import bitsum, curve, msm

torch.set_num_threads(1)

QCAP = 64  # csrc/bitsum.cuh: a warp's ring of set positions
WARPS = 4  # csrc/bitsum.cuh: runs (warps) per sweep block


# ---------------------------------------------------------------------------
# K6
# ---------------------------------------------------------------------------


def _replay_k6(group: str, points, windows: int, dbl: int, wire_major: bool,
               chunk: int = None):
    """shifted_bases_kernel's walk, every thread of a launch at once, the
    launches `chunk` points apart (affine_bases' split by its scratch):
    the doublings once, row w getting U = X c^2, V = Y c^3 ((0, 0) for a
    zero Z) and the scratch Z_w, c the running product of the nonzero Z;
    one inversion; backwards, x = U inv^2, y = V inv^3, inv <- inv Z_w."""
    ops = curve.ops_for(group)
    m = points[0].shape[0]
    pw = msm._bases_width(group) // 2
    out = torch.zeros((windows * m, 2 * pw), dtype=torch.int32)
    chunk = chunk or m
    for i0 in range(0, m, chunk):
        i = torch.arange(i0, min(m, i0 + chunk))
        n = i.numel()
        zs = torch.zeros((windows * n, pw), dtype=torch.int32)  # row w n + j

        def rows(w):
            return i * windows + w if wire_major else w * m + i

        def store(w, k, v):
            out[rows(w), k * pw:(k + 1) * pw] = msm.pack_words(v.reshape(n, -1))

        def load(w, k):
            return msm.unpack_words(out[rows(w), k * pw:(k + 1) * pw]).reshape(
                (n,) + ops.coord_shape)

        def unpack(words):
            return msm.unpack_words(words).reshape((n,) + ops.coord_shape)

        p = tuple(c[i] for c in points)
        c = ops.one((n,), "cpu")
        zero = torch.zeros_like(c)
        for w in range(windows):  # 1. the doublings once; U, V, Z_w, c
            if w:
                p = curve.times_pow2(ops, p, dbl)
            zs[w * n:(w + 1) * n] = msm.pack_words(p[2].reshape(n, -1))
            inf = ops.is_zero(p[2])
            c2 = ops.sqr(c)
            store(w, 0, ops.select(inf, zero, ops.mul(p[0], c2)))
            store(w, 1, ops.select(inf, zero, ops.mul(p[1], ops.mul(c2, c))))
            c = ops.select(inf, c, ops.mul(c, p[2]))
        inv = msm._coord_inv_plain(group, c)  # 2. one inversion per point
        for w in range(windows - 1, -1, -1):  # 3. x = U inv^2, y = V inv^3; inv <- inv Z_w
            z = unpack(zs[w * n:(w + 1) * n])
            inf = ops.is_zero(z)
            i2 = ops.sqr(inv)
            store(w, 0, ops.select(inf, load(w, 0), ops.mul(load(w, 0), i2)))
            store(w, 1, ops.select(inf, load(w, 1), ops.mul(load(w, 1), ops.mul(i2, inv))))
            inv = ops.select(inf, inv, ops.mul(inv, z))
    return out


def _points(group: str):
    """Five Jacobian points with Z != 1 (sums P + Q) and one infinity."""
    gen, mul = (G1_GEN, g1_mul) if group == "g1" else (G2_GEN, g2_mul)
    rng = np.random.default_rng(11)
    host = [mul(gen, int.from_bytes(rng.bytes(32), "little") % FR_MOD) for _ in range(10)]
    ops = curve.ops_for(group)
    p = curve.points_to_device(group, host[:5] + [None], "cpu")
    q = curve.points_to_device(group, host[5:] + [None], "cpu")
    return curve.point_add(ops, p, q)


@pytest.mark.parametrize("group", ["g1", "g2"])
@pytest.mark.parametrize("windows,dbl,wire_major,chunk", [
    (32, 8, False, None), (32, 8, False, 4), (254, 1, True, None), (1, 0, False, None),
    (1, 0, False, 4)])
def test_k6_walk_replayed_matches_plain(group, windows, dbl, wire_major, chunk):
    """K3's bases (32, 8), the plan's chains (254, 1, wire-major) and the
    conversion (1, 0), infinity included: the walk gives affine_bases_plain's
    words, in one launch and (chunk 4) in launches of 4 points and 2."""
    pts = _points(group)
    want = msm.affine_bases_plain(group, pts, windows, dbl, wire_major)
    assert torch.equal(_replay_k6(group, pts, windows, dbl, wire_major, chunk), want)


@pytest.mark.parametrize("zeros", [[0], [7], [15], [0, 7, 15], list(range(16))])
def test_k6_batched_inversion_replayed_matches_plain(zeros):
    """The walk's inversion on a raw list of 16 Z (as one point's windows),
    with zeros at the start, the middle, the end, all three and
    everywhere: each Z^-1 equals _fq_inv_plain's, 0 for a zero Z, and one
    zero leaves its neighbours alone."""
    rng = np.random.default_rng(len(zeros) + zeros[0])
    vals = [int.from_bytes(rng.bytes(32), "little") % FQ_MOD for _ in range(16)]
    for k in zeros:
        vals[k] = 0
    z = torch.from_numpy(limb.ints_to_limbs([v * (1 << 256) % FQ_MOD for v in vals]))
    ops = curve.ops_for("g1")
    one = ops.one((), "cpu")
    c, prods = one, []
    for zw in z:  # forward: c_w, a zero standing in as one
        c = ops.select(ops.is_zero(zw), c, ops.mul(c, zw))
        prods.append(c)
    inv = msm._fq_inv_plain(c)
    got = [None] * len(z)
    for w in range(len(z) - 1, -1, -1):
        zi = ops.mul(inv, prods[w - 1]) if w else inv
        got[w] = ops.select(ops.is_zero(z[w]), torch.zeros_like(zi), zi)
        inv = ops.select(ops.is_zero(z[w]), inv, ops.mul(inv, z[w]))
    assert torch.equal(torch.stack(got), msm._fq_inv_plain(z))


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def _popc(x: int) -> int:
    return bin(x).count("1")


def _replay_sweep(W, bit_idx, full_idx, counts, M: int, run: int):
    """The positions each (query, proof) adds, in the order K5's sweep adds
    them: the grid (tile B + proof, query) of WARPS runs per block, each
    warp's run a range of the query's live offsets (offset t < n_bit is
    position t, a later one mb + t - n_bit), walked 32 at a time, its set
    positions queued in the ring by the prefix count of the ballot mask
    below each lane, popped 32 at a time and, at the run's end, what is
    left. Every bit is read as the kernel reads it from W."""
    B, q = W.shape[0], bit_idx.shape[0]
    mb = bit_idx.shape[1]
    fb = bitsum.FULL_BITS
    runs = -(-M // run)
    tiles = -(-runs // WARPS)
    taken = {(qi, b): [] for qi in range(q) for b in range(B)}
    lanes = np.arange(32)
    for x in range(tiles * B):
        for qi in range(q):
            b = x % B
            nb, nf = (int(v) for v in counts[qi])
            for warp in range(WARPS):
                r = (x // B) * WARPS + warp
                if r >= runs:
                    continue
                live = nb + fb * nf  # live offsets: bit wires, then the chains
                lo = min(r * run, live)
                hi = min(lo + run, live)
                ring, head, fill = [None] * QCAP, 0, 0
                out = taken[(qi, b)]
                c = lo
                while True:
                    ts = c + lanes
                    bits = np.zeros(32, np.int64)
                    for l in lanes[ts < hi]:
                        t = int(ts[l])
                        if t < nb:
                            bits[l] = W[b, bit_idx[qi, t], 0] & 1
                        else:
                            j, k = divmod(t - nb, fb)
                            bits[l] = (W[b, full_idx[qi, j], k >> 4] >> (k & 15)) & 1
                    mask = sum(1 << int(l) for l in lanes[bits.astype(bool)])
                    for l in lanes[bits.astype(bool)]:
                        t = int(ts[l])
                        slot = (head + fill + _popc(mask & ((1 << int(l)) - 1))) % QCAP
                        ring[slot] = t if t < nb else mb + t - nb
                    fill += _popc(mask)
                    assert fill < QCAP
                    end = c + 32 >= hi
                    if fill >= 32 or end:
                        take = min(fill, 32)
                        out.extend(ring[(head + l) % QCAP] for l in range(take))
                        head, fill = (head + take) % QCAP, fill - take
                    if end and fill == 0:
                        break
                    c += 32
    return taken


def _plan_case(density: float, seed: int):
    """q = 2 queries of (n_bit, n_full) = (650, 6), (600, 4) padded to mb =
    700, mf = 6 and M = 2624 (not a multiple of 1024); B = 3 witnesses whose
    bits are set with probability `density`, and wire 0 (the padding's
    index) all ones, which must never count."""
    rng = np.random.default_rng(seed)
    q, B, mb, mf, nw = 2, 3, 700, 6, 2000
    counts = np.array([[650, 6], [600, 4]], np.int32)
    bit_idx = np.zeros((q, mb), np.int32)
    full_idx = np.zeros((q, mf), np.int32)
    for qi, (nb, nf) in enumerate(counts):
        wires = rng.permutation(np.arange(1, nw))[:nb + nf]
        bit_idx[qi, :nb], full_idx[qi, :nf] = wires[:nb], wires[nb:]
    bits = rng.random((B, nw, 16, 16)) < density
    W = (bits.astype(np.int64) << np.arange(16)).sum(-1)
    W[:, bit_idx.ravel(), 1:] = 0
    W[:, bit_idx.ravel(), 0] &= 1
    W[:, 0] = 0xFFFF
    return W, bit_idx, full_idx, counts, 2624


@pytest.mark.parametrize("density", [0.0, 1 / 64, 0.45, 1.0])
@pytest.mark.parametrize("run", ["sweep_run", 64])
def test_k5_compaction_replayed_takes_each_set_bit_once(density, run):
    """Each set position of every (query, proof) is added exactly once, no
    padding position is, and the ring never overflows: the set positions
    are plan_bits' (the plain version's). The run as sweep_run picks it on
    a card of 132 SMs with 12 resident warps each (it takes MIN_RUN here),
    and a run of 64 (many runs, chunks across the bit / full boundary)."""
    W, bit_idx, full_idx, counts, M = _plan_case(density, int(density * 64) + 3)
    B, q = W.shape[0], bit_idx.shape[0]
    if run == "sweep_run":
        run = bitsum.sweep_run(q, B, M, 12, 132)
        assert run == bitsum.MIN_RUN and M % run
    taken = _replay_sweep(W, bit_idx, full_idx, counts, M, run)
    want = bitsum.plan_bits(M, torch.from_numpy(bit_idx), torch.from_numpy(full_idx),
                            torch.from_numpy(counts), torch.from_numpy(W.astype(np.int32)))
    for (qi, b), got in taken.items():
        assert sorted(got) == want[qi, b].nonzero().flatten().tolist(), (qi, b)
        assert len(got) == len(set(got))


@pytest.mark.parametrize("q,B,M,warps,sms,want", [
    (3, 16, 294_912, 12, 132, 2240),      # Spend, G1 (a, b1, l) at B = 16
    (1, 16, 212_992, 8, 132, 1024),       # Spend, G2 (b2): MIN_RUN
    (3, 4, 12_427_264, 12, 132, 23_552),  # PoB, G1 at B = 4
    (1, 4, 6_098_944, 8, 132, 5792),      # PoB, G2
])
def test_k5_sweep_run(q, B, M, warps, sms, want):
    """sweep_run (SWEEP_WAVES 4): the positions over that many waves of the
    resident warps, rounded up to a multiple of 32, at least MIN_RUN."""
    assert bitsum.SWEEP_WAVES == 4
    run = bitsum.sweep_run(q, B, M, warps, sms)
    assert run == want and run % 32 == 0
    if run > bitsum.MIN_RUN:
        assert -(-q * B * M // run) <= bitsum.SWEEP_WAVES * warps * sms


# ---------------------------------------------------------------------------
# K3 over bases of S shifted windows
# ---------------------------------------------------------------------------


def _k3_digits(scalars, S: int):
    """K3's hist / scatter grid at S shifted windows (csrc/msm.cuh), as the
    kernels take it: block (b np + p) chunks + c takes pass p of proof b over
    scalars (c np + r) HT + t, r < np, windows p S .. p S + S - 1; a nonzero
    digit d of window w of point i goes to bucket d of key b np + p as row
    (w mod S) m + i of the bases. Returns (keys, rows, how many times each
    digit was taken)."""
    B, m = scalars.shape[:2]
    npass = msm.N_WINDOWS // S
    HT = msm.HIST_CHUNK
    dig = msm.scalar_digits(scalars).numpy()
    chunks = -(-m // (HT * npass))
    taken = np.zeros(dig.shape, np.int64)
    keys, rows = [], []
    for blk in range(B * npass * chunks):
        key = blk // chunks
        b, p = divmod(key, npass)
        c = blk - key * chunks
        i = ((c * npass + np.arange(npass)[:, None]) * HT + np.arange(HT)).ravel()
        i = i[i < m]
        for win in range(p * S, p * S + S):
            taken[b, i, win] += 1
            d = dig[b, i, win]
            keys.append(key * msm.N_BUCKETS + d[d != 0])
            rows.append((win - p * S) * m + i[d != 0])
    return np.concatenate(keys), np.concatenate(rows), taken


def _replay_k3(group: str, points, scalars, S: int):
    """K3 at S shifted windows replayed: the digits through _k3_digits into
    the bases (affine_bases_plain at (S, 8)), the buckets summed, each key's
    weighted sum sum_d d B_d formed, and each proof's passes folded from the
    top with 8 S doublings between them."""
    ops = curve.ops_for(group)
    B = scalars.shape[0]
    npass = msm.N_WINDOWS // S
    keys, rows, taken = _k3_digits(scalars, S)
    assert (taken == 1).all()
    bases = msm.affine_bases_plain(group, points, S, msm.WINDOW_BITS)
    order = np.argsort(keys, kind="stable")
    pts = msm.packed_to_jacobian(group, bases[torch.from_numpy(rows[order])])
    bkey, bsum = msm.segment_sum(ops, torch.from_numpy(keys[order]), pts)
    nk, nb = B * npass, msm.WINDOW_BITS
    # each key's weighted sum: sum_d d B_d = sum_j 2^j (sum of B_d over the d with bit j)
    bit = (bkey[:, None] >> torch.arange(nb)) & 1
    k, j = bit.nonzero(as_tuple=True)
    jkey, order = torch.sort(bkey[k] // msm.N_BUCKETS * nb + j, stable=True)
    jkey, jsum = msm.segment_sum(ops, jkey, tuple(c[k[order]] for c in bsum))
    per_bit = msm._scatter(ops, nk * nb, jkey, jsum, "cpu")
    acc = msm.horner_bits(ops, tuple(c.reshape((nk, nb) + c.shape[1:]) for c in per_bit))
    v = tuple(c.reshape((B, npass) + c.shape[1:]) for c in acc)
    out = tuple(c[:, npass - 1] for c in v)
    for p in range(npass - 2, -1, -1):
        out = curve.point_add(ops, curve.times_pow2(ops, out, msm.WINDOW_BITS * S),
                              tuple(c[:, p] for c in v))
    return out


@pytest.mark.parametrize("S,m", [(1, 24), (2, 20), (8, 24), (32, 17)])
def test_k3_passes_replayed_match_plain(S, m):
    """K3's pass mapping and fold at S = 1, 2, 8, 32 on G1 (the card's tests
    hold G2 at S = 1, 2, 8, 16), m <= 24: two proofs,
    random scalars with the digit edges 0x7F, 0x80, 0xFF and r - 1 and a
    zero scalar among them, over points with Z != 1 and an infinite one;
    the replay equals msm_plain."""
    group = "g1"
    ops = curve.ops_for(group)
    rng = np.random.default_rng(S + m)
    pts = _points(group)  # 5 with Z != 1, then infinity; more as sums of neighbours
    while pts[0].shape[0] < m:
        pts = tuple(torch.cat(cs, 0) for cs in zip(pts, curve.point_add(
            ops, pts, tuple(c.roll(1, 0) for c in pts))))
    pts = tuple(c[:m] for c in pts)
    vals = [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(2 * m)]
    vals[:5] = [0x7F, 0x80 << 120, 0xFF << 248 & ((1 << 254) - 1), FR_MOD - 1, 0]
    sc = torch.from_numpy(limb.ints_to_limbs(vals)).reshape(2, m, limb.L)
    got = _replay_k3(group, pts, sc, S)
    assert bool(curve.points_equal(ops, got, msm.msm_plain(ops, pts, sc)).all())


@pytest.mark.parametrize("S", [1, 2, 8, 32])
def test_k3_grid_takes_each_digit_once(S):
    """At m = 20,000 (several chunks of every pass) and B = 2, the hist /
    scatter grid takes every digit of every proof exactly once, and the
    rows it writes stay inside the S m rows of the bases."""
    m = 20000
    rng = np.random.default_rng(S)
    sc = torch.from_numpy(rng.integers(0, 1 << 16, (2, m, limb.L)).astype(np.int32))
    keys, rows, taken = _k3_digits(sc, S)
    assert (taken == 1).all()
    assert keys.size == int((msm.scalar_digits(sc) != 0).sum())
    assert rows.min() >= 0 and rows.max() < S * m
    assert keys.max() < 2 * (msm.N_WINDOWS // S) * msm.N_BUCKETS


def test_k3_caps_per_pass():
    """One key space of B (32 / S) 256 buckets at the production h query
    (m = 2^24, 9 levels, B <= 3): level_caps grow by the passes' keys only;
    at S = 32 they are those of one pass."""
    m = 1 << 24
    segs = msm.level_segs(msm.N_WINDOWS * m)
    assert len(segs) == 9 and msm.k3_max_batch(m) == 3
    assert msm.level_caps(3, m, segs) == msm.level_caps(3, m, segs, 1)
    c1, c4 = msm.level_caps(1, m, segs, 1), msm.level_caps(1, m, segs, 4)
    assert c1[0] == c4[0] == 32 * m and c4[1] == c1[1] + 3 * 256
