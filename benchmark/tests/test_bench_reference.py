"""The plain reference on the CPU: its field arithmetic against python ints,
its curve and hash copies on known values, its Groth16 proofs against the
program's on a toy circuit, and the scan that keeps JAX, pob_tpu and (in
the reference) the program out of the benchmark's modules."""

import ast
import os
import random

import pytest
import torch

from benchmark.reference import curve, fr, keccak, poseidon
from benchmark.reference.groth16 import Shadow

R = fr.R_MOD
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _t(xs):
    return torch.from_numpy(fr.to_limbs(xs))


@pytest.mark.parametrize("chunk", [1 << 20, 7])
def test_field_ops_match_ints(chunk, monkeypatch):
    monkeypatch.setattr(fr, "CHUNK", chunk)
    rnd = random.Random(1)
    xs = [rnd.randrange(R) for _ in range(200)] + [0, 1, R - 1]
    ys = [rnd.randrange(R) for _ in range(200)] + [R - 1, 0, R - 1]
    a, b = _t(xs), _t(ys)
    rinv = pow(1 << 256, -1, R)
    assert fr.from_limbs(fr.mont_mul(a, b)) == [x * y * rinv % R for x, y in zip(xs, ys)]
    assert fr.from_limbs(fr.add(a, b)) == [(x + y) % R for x, y in zip(xs, ys)]
    assert fr.from_limbs(fr.sub(a, b)) == [(x - y) % R for x, y in zip(xs, ys)]
    assert fr.from_limbs(fr.from_mont(fr.to_mont(a))) == xs
    nz = [x or 3 for x in xs]
    inv = fr.from_mont(fr.batch_inv_mont(fr.to_mont(_t(nz)), cols=16))
    assert fr.from_limbs(inv) == [pow(x, -1, R) for x in nz]
    assert fr.from_limbs(fr.from_mont(fr.powers_mont(7, 37, "cpu"))) == [
        pow(7, i, R) for i in range(37)]


def test_wide_reduction_and_dot_products():
    rnd = random.Random(2)
    t = torch.randint(0, 1 << 38, (9, 17))
    vals = [sum(int(t[i, k]) << (16 * k) for k in range(17)) for i in range(9)]
    assert fr.from_limbs(fr.redc(t)) == [v * pow(1 << 256, -1, R) % R for v in vals]
    w = torch.randint(0, 1 << 16, (3, 40, 16))
    v = _t([rnd.randrange(R) for _ in range(80)]).reshape(40, 2, 16)
    W = [fr.from_limbs(w[i]) for i in range(3)]
    V = fr.from_limbs(v.reshape(80, 16))
    want = [[sum(W[i][k] * V[2 * k + q] for k in range(40)) % R for q in range(2)]
            for i in range(3)]
    assert fr.dot_many(w, v, rows=9) == want


def test_curve_known_values():
    # 2 G1 (EIP-196's test vectors), the groups' order, and G2 on its twist
    assert curve.g1(2) == (
        1368015179489954701390400359078579693043519447331113978918064868415326638035,
        9918110051302171585080402603319702774565515993150576347155970296011118125764)
    assert curve.g1(R) is None and curve.g2(R) is None and curve.g1(0) is None
    assert curve.g1(R - 1) == (1, curve.Q_MOD - 2)
    x, y = curve.g2(5)
    X, Y = curve.Fq2(*x), curve.Fq2(*y)
    b = curve.Fq2(3, 0) * curve.Fq2(9, 1).inv()
    assert (Y * Y - X * X * X - b).is_zero()
    assert curve.g2(3) == curve.mul(curve.G2, 3)


def test_hash_known_values():
    assert keccak.keccak256(b"").hex() == (
        "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470")
    assert keccak.keccak256(b"abc").hex() == (
        "4e03657aea45a94fc7d47ba826c8d667c0d1e6e33a64a036ec44f58fa12d6c45")
    # circomlib's poseidon([1, 2])
    assert poseidon.poseidon([1, 2]) == (
        7853200120776062878684798364095072458815029376092732009249414926327459813530)


def test_shadow_proofs_equal_the_programs():
    """The reference's proof of each witness equals the program's, bit for
    bit, on a toy circuit; without the blinding (the control) it differs,
    and so does the proof of a witness that breaks a constraint."""
    from benchmark.harness.r1cs import arrays as r1cs_arrays
    from benchmark.tests.toy import toy
    from pob_tpu_torch.field import limb
    from pob_tpu_torch.prover import groth16

    cs = toy.build()
    rnd = random.Random(5)
    toxic = [rnd.randrange(1, R) for _ in range(5)]
    pk, _ = groth16.setup(cs, rng=iter(toxic).__next__, device="cpu")
    x = rnd.randrange(R)
    good = [1, (x ** 3 + x + 5) % R, x, x * x % R, x ** 3 % R]
    bad = list(good)
    bad[4] = (bad[4] + 1) % R
    W = torch.from_numpy(limb.ints_to_limbs(good + bad).reshape(2, 5, 16))
    rs = [(rnd.randrange(R), rnd.randrange(R)) for _ in range(2)]
    proofs = groth16.prove_batch(pk, W, rs=rs)
    sh = Shadow(r1cs_arrays(cs), toxic, "cpu")
    dots = sh.scalars(W)
    assert tuple(proofs[0]) == sh.expected(dots[0], *rs[0])
    assert tuple(proofs[0]) != sh.expected(dots[0], *rs[0], blind=False)
    assert tuple(proofs[1]) != sh.expected(dots[1], *rs[1])


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def _modules():
    for d, _, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_pob_tpu():
    seen = 0
    for path in _modules():
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "pob_tpu"}, path
        seen += 1
    assert seen > 20


def test_reference_imports_nothing_of_the_program():
    rel = [p for p in _modules()
           if os.sep + "reference" + os.sep in p or p.endswith("_ref.py")]
    assert len(rel) >= 7
    for path in rel:
        assert "pob_tpu_torch" not in set(_imports(path)), path
        # names are compared whole: pob_tpu_torch begins with pob_tpu
        assert all(n != "pob_tpu" for n in _imports(path)), path
