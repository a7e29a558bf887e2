"""The port's interchange formats (pob_tpu_torch/prover/serialize.py and the
zkey / npz functions of its groth16) against pob_tpu's, on the CPU, with
tolerance 0: the same bytes out, the same values back.

The toy circuit of tests/test_groth16.py is keyed by pob_tpu's setup_host
and carried into the port through save_pk / load_pk. pob_tpu's write_zkey
makes its affine points with curve.affine_mont_batch, which runs op by op
for about 30 s on the CPU; the fixture jits it (the same function, so the
same bytes) for about 12 s. A proof on the CPU costs about 7 s (its plain
MSMs), so where only a valid proof is needed, simulated_proof makes one
from the toxic waste on the host."""

import json
import random
import struct
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_groth16 import toy_cs, toy_witness  # noqa: E402

from pob_tpu.prover import curve as jc  # noqa: E402
from pob_tpu.prover import groth16 as jg  # noqa: E402
from pob_tpu.prover import serialize as js  # noqa: E402
from pob_tpu.r1cs.builder import ConstraintSystem  # noqa: E402
from pob_tpu_torch.field import limb as tl  # noqa: E402
from pob_tpu_torch.field.ref import FR_MOD, G1_GEN, G2_GEN, g1_mul, g2_mul  # noqa: E402
from pob_tpu_torch.prover import groth16 as tg  # noqa: E402
from pob_tpu_torch.prover import serialize as ts  # noqa: E402

torch.set_num_threads(1)

SEED_SCALARS = [random.Random(11).randrange(1, FR_MOD) for _ in range(5)]
_RINV = pow((1 << 256) % FR_MOD, FR_MOD - 2, FR_MOD)


@pytest.fixture(scope="module")
def keyed(tmp_path_factory):
    """(cs, pob_tpu pk, vk, the port's pk, vk, pob_tpu's zkey bytes, dir)."""
    d = tmp_path_factory.mktemp("zkey")
    cs = toy_cs()
    pk, vk = jg.setup_host(cs, rng=iter(SEED_SCALARS).__next__)
    jg.save_pk(str(d / "pk.npz"), pk, vk)
    tpk, tvk = tg.load_pk(str(d / "pk.npz"), device="cpu")
    orig = jc.affine_mont_batch
    jc.affine_mont_batch = jax.jit(orig, static_argnums=0)
    try:
        js.write_zkey(str(d / "jax.zkey"), pk, vk, cs)
    finally:
        jc.affine_mont_batch = orig
    return cs, pk, vk, tpk, tvk, (d / "jax.zkey").read_bytes(), d


def simulated_proof(cs, toxic, publics, a=1234567, b=7654321):
    """A proof that verifies for the key of `toxic` (tau, alpha, beta,
    gamma, delta): A = a G1, B = b G2 and C = (a b - alpha beta - gamma
    sum_i x_i ic_i) / delta G1, ic_i the setup's IC scalars, x_0 = 1."""
    _, alpha, beta, gamma, delta = toxic
    _, sc, _ = tg.setup_scalars(cs, toxic)
    s_ic = sum(x * c for x, c in zip([1, *publics], sc["ic"])) % FR_MOD
    c = (a * b - alpha * beta - gamma * s_ic) * pow(delta, FR_MOD - 2, FR_MOD) % FR_MOD
    return (g1_mul(G1_GEN, a), g2_mul(G2_GEN, b), g1_mul(G1_GEN, c))


def _wits():
    return [toy_witness(300 + i, 900 + 7 * i) for i in range(2)]


def test_wtns_bytes_equal_jax(tmp_path):
    w = [1, 5, FR_MOD - 1, 0, 1 << 200]
    js.write_wtns(str(tmp_path / "j.wtns"), w)
    ts.write_wtns(str(tmp_path / "t.wtns"), tl.ints_to_limbs(w))
    assert (tmp_path / "t.wtns").read_bytes() == (tmp_path / "j.wtns").read_bytes()
    assert ts.read_wtns(str(tmp_path / "t.wtns")) == js.read_wtns(str(tmp_path / "j.wtns"))
    assert ts.read_wtns(str(tmp_path / "t.wtns")) == (FR_MOD, w)


def _golden_cs():
    cs = ConstraintSystem()  # the 1-constraint system of test_serialize_golden
    x = cs.alloc_block("x", (1,))
    cs.mark_public(1)
    cs.add([(int(x[0]), 2)], [(int(x[0]), 3)], [(int(x[0]), 6)])
    return cs


def _unordered_cs():
    """Rows out of order and a row with several terms per matrix, so the
    grouping by row is exercised."""
    cs = ConstraintSystem()
    cs.alloc_block("pub", (1,))
    cs.mark_public(1)
    v = [int(w) for w in cs.alloc_block("v", (4,))]
    cs.add([(v[0], 3), (v[1], FR_MOD - 1)], [(v[2], 1)], [(v[3], 5), (1, 2)])
    cs.add([(v[1], 1)], [(0, 7), (v[0], 1), (v[3], 9)], [])
    cs.add([], [(v[2], 4)], [(v[0], 1)])
    return cs


@pytest.mark.parametrize("make", [toy_cs, _golden_cs, _unordered_cs],
                         ids=["toy", "golden", "unordered"])
def test_r1cs_bytes_equal_jax(tmp_path, make):
    cs = make()
    js.write_r1cs(str(tmp_path / "j.r1cs"), cs)
    ts.write_r1cs(str(tmp_path / "t.r1cs"), cs)
    assert (tmp_path / "t.r1cs").read_bytes() == (tmp_path / "j.r1cs").read_bytes()
    got = ts.read_r1cs(str(tmp_path / "t.r1cs"))
    assert got == js.read_r1cs(str(tmp_path / "j.r1cs"))
    assert got["num_constraints"] == cs.num_constraints and got["num_wires"] == cs.num_wires


@pytest.mark.parametrize("make", [toy_cs, _unordered_cs], ids=["toy", "unordered"])
def test_snarkjs_matrices_equal_jax(make):
    cs = make()
    for got, want in zip(tg.snarkjs_matrices(cs), jg.snarkjs_matrices(cs)):
        for g, w in zip(got, want):
            assert [int(x) for x in g] == [int(x) for x in w]


def test_json_text_equal_jax(keyed, tmp_path):
    cs, pk, vk, tpk, tvk, _, _ = keyed
    w, pub = _wits()[0]
    proof = simulated_proof(cs, SEED_SCALARS, pub)
    assert tg.verify(tvk, proof, pub)
    for mod, name in ((js, "j"), (ts, "t")):
        mod.write_proof(str(tmp_path / f"{name}_proof.json"), proof, pub)
        with open(tmp_path / f"{name}_vk.json", "w") as f:
            json.dump(mod.vk_to_snarkjs(vk if mod is js else tvk), f, indent=1)
    for f in ("proof", "public", "vk"):
        assert (tmp_path / f"t_{f}.json").read_text() == (tmp_path / f"j_{f}.json").read_text()
    d = json.loads((tmp_path / "t_proof.json").read_text())
    assert ts.snarkjs_to_proof(d) == js.snarkjs_to_proof(d) == proof
    v = ts.snarkjs_to_vk(json.loads((tmp_path / "t_vk.json").read_text()))
    assert (v.alpha1, v.beta2, v.gamma2, v.delta2, v.ic) == (
        vk.alpha1, vk.beta2, vk.gamma2, vk.delta2, vk.ic)


def test_zkey_bytes_equal_jax(keyed, tmp_path):
    cs, _, _, tpk, tvk, zkey, _ = keyed
    ts.write_zkey(str(tmp_path / "t.zkey"), tpk, tvk, cs)
    assert (tmp_path / "t.zkey").read_bytes() == zkey


def test_read_zkey_equals_jax(keyed):
    *_, d = keyed
    want, got = js.read_zkey(str(d / "jax.zkey")), ts.read_zkey(str(d / "jax.zkey"))
    assert set(got) == set(want)
    for k in want:
        if k.endswith("_pts"):
            np.testing.assert_array_equal(got[k], want[k])
        elif k != "coeffs":
            assert got[k] == want[k], k
    for m in (0, 1):
        rows, cols, vals = got["coeffs"][m]
        assert list(rows) == want["coeffs"][m][0] and list(cols) == want["coeffs"][m][1]
        assert [v * _RINV % FR_MOD for v in tl.limb_rows_to_ints(vals)] == want["coeffs"][m][2]


def test_load_zkey_matches_jax_and_proves(keyed):
    cs, pk, vk, tpk, tvk, _, d = keyed
    lpk, lvk = tg.load_zkey(str(d / "jax.zkey"), device="cpu")
    jpk, jvk = jg.load_zkey(str(d / "jax.zkey"))
    assert (lvk.alpha1, lvk.beta2, lvk.gamma2, lvk.delta2, lvk.ic) == (
        jvk.alpha1, jvk.beta2, jvk.gamma2, jvk.delta2, jvk.ic)
    assert (lpk.k, lpk.num_public, lpk.alpha1, lpk.beta1, lpk.delta1, lpk.beta2, lpk.delta2) == (
        jpk.k, jpk.num_public, jpk.alpha1, jpk.beta1, jpk.delta1, jpk.beta2, jpk.delta2)
    for name, _ in tg.MSM_QUERIES:
        for c, jcoord in zip(getattr(lpk, name), getattr(jpk, name)):
            np.testing.assert_array_equal(c.numpy(), np.asarray(jcoord), err_msg=name)
    for (r, c, f), (jr, jcol, jf) in zip(lpk.mats, jpk.mats):
        np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jcol))
        np.testing.assert_array_equal(f.numpy(), np.asarray(jf))
    w, pub = _wits()[1]
    got = tg.prove(lpk, tl.ints_to_limbs(w), r=5, s=6)
    assert got == tg.prove(tpk, tl.ints_to_limbs(w), r=5, s=6)
    assert tg.verify(lvk, got, pub)


def test_save_pk_arrays_equal_jax(keyed):
    *_, tpk, tvk, _, d = keyed
    tg.save_pk(str(d / "t_pk.npz"), tpk, tvk)
    with np.load(str(d / "pk.npz")) as want, np.load(str(d / "t_pk.npz")) as got:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---- every case of tests/test_serialize_negative.py, on both readers ----


def _offsets(data: bytes):
    _v, n = struct.unpack_from("<II", data, 4)
    off, out = 12, {}
    for _ in range(n):
        sid, slen = struct.unpack_from("<iq", data, off)
        out[sid] = (off, off + 12, slen)
        off += 12 + slen
    return out


def _patch(data, fmt, where, *vals):
    b = bytearray(data)
    struct.pack_into(fmt, b, where, *vals)
    return bytes(b)


def _bad_magic(z):
    return b"zkex" + z[4:]


def _truncate(frac):
    return lambda z: z[:max(4, int(len(z) * frac))]


def _wrong_n8(z):
    return _patch(z, "<I", _offsets(z)[2][1], 48)


def _wrong_prime(z):
    b = bytearray(z)
    b[_offsets(z)[2][1] + 4] ^= 0xFF
    return bytes(b)


def _lying_length(z):
    return _patch(z, "<q", _offsets(z)[5][0] + 4, len(z) * 2)


def _point_count(z):
    hdr, body, slen = _offsets(z)[5]
    b = bytearray(_patch(z, "<q", hdr + 4, slen - 64))
    del b[body:body + 64]
    return bytes(b)


def _missing_section(z):
    hdr, body, slen = _offsets(z)[9]
    b = bytearray(z)
    del b[hdr:body + slen]
    v, n = struct.unpack_from("<II", b, 4)
    struct.pack_into("<II", b, 4, v, n - 1)
    return bytes(b)


def _coeff_count(z):
    body = _offsets(z)[4][1]
    return _patch(z, "<I", body, struct.unpack_from("<I", z, body)[0] + 3)


def _coeff_wire(z):
    return _patch(z, "<I", _offsets(z)[4][1] + 4 + 8, 10_000)


REJECTS = {"bad_magic": _bad_magic, **{f"truncation_{f}": _truncate(f)
                                       for f in (0.1, 0.5, 0.9, 0.999)},
           "wrong_n8": _wrong_n8, "wrong_prime": _wrong_prime, "lying_length": _lying_length,
           "point_count": _point_count, "missing_section": _missing_section,
           "coeff_count": _coeff_count, "coeff_wire_out_of_range": _coeff_wire}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_broken_zkey_rejected_like_jax(keyed, tmp_path, case):
    *_, zkey, _ = keyed
    p = tmp_path / "bad.zkey"
    p.write_bytes(REJECTS[case](zkey))
    with pytest.raises((js.ZkeyFormatError, AssertionError)):
        js.read_zkey(str(p))
    with pytest.raises(ts.ZkeyFormatError):
        ts.read_zkey(str(p))


def test_section_reordering_tolerated_like_jax(keyed, tmp_path):
    *_, zkey, _ = keyed
    offs = _offsets(zkey)
    chunks = {sid: zkey[h:b + n] for sid, (h, b, n) in offs.items()}
    p = tmp_path / "reordered.zkey"
    p.write_bytes(zkey[:12] + b"".join(chunks[s] for s in [3, 1, 9, 2, 5, 4, 7, 6, 8, 10]))
    d0, d1 = ts.read_zkey(str(p)), js.read_zkey(str(p))
    assert d0["alpha1"] == d1["alpha1"] and d0["ic"] == d1["ic"]
    np.testing.assert_array_equal(d0["h_pts"], d1["h_pts"])
    base = ts.read_zkey(str(keyed[-1] / "jax.zkey"))
    for k in ("a_pts", "b2_pts", "h_pts"):
        np.testing.assert_array_equal(d0[k], base[k])
