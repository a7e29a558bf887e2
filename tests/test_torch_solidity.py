"""The port's Solidity verifier export (pob_tpu_torch/prover/solidity.py)
against pob_tpu's on the CPU: the same source text, the same calldata, and
parse_solidity_vk gives the same key back (tolerance 0). The verifying
keys come from pob_tpu's setup_host on the circuits of tests/test_solidity.py
(one public input, and three for the IC fold)."""

import random

import pytest

from pob_tpu.field.ref import FR_MOD
from pob_tpu.prover import groth16 as jg
from pob_tpu.prover import solidity as jsol
from pob_tpu.r1cs.builder import ConstraintSystem
from pob_tpu_torch.prover import solidity as tsol


def _vk(n_public: int, seed: int):
    cs = ConstraintSystem()
    pub = cs.alloc_block("pub", (n_public,))
    cs.mark_public(n_public)
    priv = cs.alloc_block("priv", (2,))
    for i in range(n_public):
        cs.add([(int(priv[0]), i + 1)], [(int(priv[1]), 1)], [(int(pub[i]), 1)])
    rnd = random.Random(seed)
    return jg.setup_host(cs, rng=lambda: rnd.randrange(1, FR_MOD))[1]


@pytest.fixture(scope="module")
def vks():
    return {1: _vk(1, 7), 3: _vk(3, 3)}


@pytest.mark.parametrize("n_public", [1, 3])
@pytest.mark.parametrize("name", ["Groth16Verifier", "PobVerifier"])
def test_solidity_source_equal_jax(vks, n_public, name):
    vk = vks[n_public]
    src = tsol.vk_to_solidity(vk, name)
    assert src == jsol.vk_to_solidity(vk, name)
    consts, key = tsol.parse_solidity_vk(src)
    assert (consts, key) == jsol.parse_solidity_vk(src)
    assert key == (vk.alpha1, vk.beta2, vk.gamma2, vk.delta2, list(vk.ic))
    for i in range(n_public):
        assert f"input[{i}]" in src and f"IC{i + 1}x" in src


def test_calldata_equal_jax():
    proof = ((11, 22), ((31, 32), (41, 42)), (51, 52))
    for pubs in ([7, FR_MOD + 5], [], [FR_MOD - 1, 0, 3]):
        assert tsol.proof_to_calldata(proof, pubs) == jsol.proof_to_calldata(proof, pubs)
    assert tsol.proof_to_calldata((None, None, None), [1]) == jsol.proof_to_calldata(
        (None, None, None), [1])
