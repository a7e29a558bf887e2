"""K4 (pob_tpu_torch.prover.msm, fixed-base scalar multiplication of the
setup) on the CPU: the plain window table against python ints, the plain
fixed_base_msm against pob_tpu.prover.msm.windowed_fixed_base_msm and the
curve reference, the batched plain inversion both tables use, and the
kernels' index math (table rows, digits, packed offsets) replayed with ints
mod r standing in for points. Tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pob_tpu.field import limb as jl
from pob_tpu.prover import curve as jc
from pob_tpu.prover import msm as jm
from pob_tpu_torch.field import limb
from pob_tpu_torch.field.ref import FQ_MOD, FR_MOD, G1_GEN, G2_GEN, g1_add, g1_mul, g2_add
from pob_tpu_torch.prover import curve, msm

torch.set_num_threads(1)

_R = (1 << 256) % FQ_MOD
_R_INV = pow(_R, FQ_MOD - 2, FQ_MOD)
# 0x30 is the largest top digit of a canonical scalar; 0x17 << 248 has its
# only nonzero digit in window 31
EDGES = [0, 1, FR_MOD - 1, 0x30 << 248, 0x17 << 248, 0xFF, 0x80 << 128]


def _scalars(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % FR_MOD for _ in range(n)]


def _words_to_ints(words) -> list:
    """(..., 8) packed words -> python ints, out of Montgomery form."""
    w = words.numpy().astype(np.int64) & 0xFFFFFFFF
    return [sum(int(v) << (32 * j) for j, v in enumerate(row)) * _R_INV % FQ_MOD
            for row in w.reshape(-1, 8)]


def _host_table(group: str, windows) -> list:
    """[v 2^(8w) G for w in windows, v < 256] as host points (None for
    v = 0); the window bases by host doublings."""
    gen, add = (G1_GEN, g1_add) if group == "g1" else (G2_GEN, g2_add)
    rows, base = {}, gen
    for w in range(max(windows) + 1):
        if w in windows:
            rows[w], acc = [], None
            for _ in range(msm.N_BUCKETS):
                rows[w].append(acc)
                acc = add(acc, base)
        for _ in range(8):
            base = add(base, base)
    return [p for w in windows for p in rows[w]]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_table_plain_vs_host(group):
    """Rows of windows 0, 1 and 31: the packed affine words of v 2^(8w) G,
    (0, 0) for v = 0."""
    windows = (0, 1, 31)
    got = msm.fixed_base_table_plain(group, "cpu", windows)
    width = limb.L * (1 if group == "g1" else 2)
    assert got.dtype == torch.int32 and got.shape == (len(windows) * msm.N_BUCKETS, width)
    vals = _words_to_ints(got)
    per = len(vals) // got.shape[0]  # ints per row: x, y (G1) or x0, x1, y0, y1 (G2)
    want = _host_table(group, windows)
    for r, p in enumerate(want):
        row = vals[r * per:(r + 1) * per]
        if p is None:
            assert row == [0] * per, r
        elif group == "g1":
            assert tuple(row) == p, r
        else:
            assert ((row[0], row[1]), (row[2], row[3])) == p, r


def test_fixed_base_plain_matches_jax_windowed():
    """fixed_base_msm's plain version on G1 against windowed_fixed_base_msm
    over a table made from host ints (as groth16._window_table lays it out:
    (32, 256) points), and against g1_mul."""
    scalars = EDGES + _scalars(13, 61)
    table = _host_table("g1", range(msm.N_WINDOWS))
    jtab = tuple(c.reshape((msm.N_WINDOWS, msm.N_BUCKETS) + c.shape[1:])
                 for c in jc.g1_points_to_device(table))
    jsc = jnp.asarray(jl.ints_to_limbs(scalars))
    want = jax.jit(lambda t, s: jm.windowed_fixed_base_msm(jc.FqOps, t, s))(jtab, jsc)
    got = msm.fixed_base_msm("g1", torch.from_numpy(limb.ints_to_limbs(scalars)))
    host = [g1_mul(G1_GEN, s) if s else None for s in scalars]
    assert curve.to_affine_host_batch("fq", got) == host
    assert [jc.to_affine_host("fq", tuple(c[i] for c in want))
            for i in range(len(scalars))] == host


@pytest.mark.parametrize("n", [1, 2, 7, 300])
def test_fq_inv_plain_vs_ints(n):
    """The batched inversion of the plain tables: odd sizes pad the product
    tree; zeros map to 0 without spoiling the others."""
    xs = [x % FQ_MOD for x in _scalars(n, 70 + n)]
    for j in range(0, n, 3):
        xs[j] = 0
    a = torch.from_numpy(limb.ints_to_limbs([x * _R % FQ_MOD for x in xs]))
    got = msm._fq_inv_plain(a.reshape(n, 1, limb.L)).reshape(n, limb.L)
    assert [limb.limbs_to_int(r) * _R_INV % FQ_MOD for r in got.numpy()] == [
        pow(x, FQ_MOD - 2, FQ_MOD) if x else 0 for x in xs]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_k4_index_math_replayed_with_ints(group):
    """csrc/fixed_base.cu step by step, ints mod r standing in for points
    (the discrete log to base G): doublings_kernel stores 2^j at packed
    Jacobian slot j (3 PW words); table_kernel sums slots 8w + b over the
    set bits b of v into row w * 256 + v (x at word 0, y at word PW of 2 PW);
    window_kernel reads digit w of a scalar from its 16-bit limbs and adds
    row w * 256 + d for each nonzero digit. The sum never equals +-the
    entry it meets (the case a mixed add would have to double or cancel)."""
    pw = 8 if group == "g1" else 16
    dbl = [None] * (msm.N_BUCKETS * 3 * pw)
    for j in range(msm.N_BUCKETS):
        dbl[j * 3 * pw] = pow(2, j, FR_MOD)
    table = [None] * (msm.TABLE_ROWS * 2 * pw)
    for e in range(msm.TABLE_ROWS):
        w, v = e // msm.N_BUCKETS, e % msm.N_BUCKETS
        acc = sum(dbl[(8 * w + b) * 3 * pw] for b in range(8) if (v >> b) & 1) % FR_MOD
        table[e * 2 * pw], table[e * 2 * pw + pw] = acc, ("y", acc)
    scalars = EDGES + _scalars(40, 80)
    limbs = limb.ints_to_limbs(scalars)
    adds = 0
    for k, s in zip(scalars, limbs.tolist()):
        acc, first = 0, True
        for w in range(msm.N_WINDOWS):
            d = (s[w >> 1] >> (8 * (w & 1))) & 0xFF
            if d:
                a = (w * msm.N_BUCKETS + d) * 2 * pw
                x, y = table[a], table[a + pw]
                assert y == ("y", x) and x == d * pow(2, 8 * w, FR_MOD) % FR_MOD
                if not first:
                    assert acc not in (x, (FR_MOD - x) % FR_MOD)
                    adds += 1
                acc, first = (acc + x) % FR_MOD, False
        assert acc == k
    nz = (msm.scalar_digits(torch.from_numpy(limbs)) != 0).sum()
    assert adds == int(nz) - sum(1 for k in scalars if k)  # the bound's mixed-add count
