"""The port's ProofOfBurn path on the CPU against pob_tpu, at a small
instantiation SMALL = PoBConfig(2, 3, 5, ...) (2 layers of 408 bytes; the
fixture cut to its two used layers, 308 and 115 bytes long):

- the port's build_pob_cs(SMALL) equals pob_tpu's (blocks, counts, the
  palette-indexed matrices);
- one call of the port's pob_r1cs_witness(SMALL) for a batch of 4 (the
  fixture, the fixture with _proofExtraCommitment + 1, and the fixture with
  byte 0 of layer 0 or of layer 1 corrupted): the first two satisfy
  pob_tpu's constraint system and carry pob_tpu's golden commitment on
  wire 1, the corrupted two violate it;
- the witness helpers (keccak traces, hint helpers, the leaf detector,
  substring and MPT-leaf gadget witnesses, inversion, the keccak sponge)
  block by block against pob_tpu's;
- the port's pob_forward(TEST_CONFIG) on the fixture and four corrupted
  variants gives tests/test_pob.py's commitments and valid flags;
- the fixture widened to PROD_CONFIG equals pob_tpu's widened input.

The full block-by-block comparison with pob_tpu's jitted
pob_r1cs_witness(SMALL) costs minutes of cold JAX compile, so it runs only
with POB_RUN_SLOW set (the gate of tests/test_r1cs_pob.py). Tolerance 0."""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pob_tpu.circuits import proof_of_burn as jpob
from pob_tpu.field import limb as jl
from pob_tpu.harness import inputs as jinputs
from pob_tpu.hash import keccak as jk
from pob_tpu.r1cs import pob_circuit as jpc
from pob_tpu.r1cs import witness as jw
from pob_tpu_torch.circuits.proof_of_burn import TEST_CONFIG, PoBConfig, pob_forward
from pob_tpu_torch.field import limb
from pob_tpu_torch.field.ref import FR_MOD
from pob_tpu_torch.harness import inputs
from pob_tpu_torch.hash import keccak, keccak_ref
from pob_tpu_torch.r1cs import pob_circuit as tpc
from pob_tpu_torch.r1cs import witness as tw
from pob_tpu_torch.r1cs.spend_circuit import assemble_witness

torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "pob_input.json")
SMALL = PoBConfig(2, 3, 5, 20, 31, 2, 10**18, 10**19)
J_SMALL = jpob.PoBConfig(2, 3, 5, 20, 31, 2, 10**18, 10**19)


def _small_cases():
    with open(FIX) as f:
        base = json.load(f)
    small = dict(base, layers=[l[:SMALL.max_node_bytes] for l in base["layers"][:2]],
                 layerLens=base["layerLens"][:2])
    assert small["layerLens"] == [308, 115] and small["numLayers"] == 2
    cases = [small, dict(small, _proofExtraCommitment=int(small["_proofExtraCommitment"]) + 1)]
    for li in (0, 1):
        bad = copy.deepcopy(small)
        bad["layers"][li][0] ^= 0xFF
        cases.append(bad)
    return cases


EXPECT_OK = [True, True, False, False]


@pytest.fixture(scope="module")
def cases():
    return _small_cases()


@pytest.fixture(scope="module")
def kwargs(cases):
    return inputs.to_device(inputs.batch_stack([inputs.load_pob_input(c, SMALL)
                                                for c in cases]), "cpu")


@pytest.fixture(scope="module")
def port_blocks(kwargs):
    return tpc.pob_r1cs_witness(SMALL, **kwargs)


@pytest.fixture(scope="module")
def jax_cs():
    return jpc.build_pob_cs(J_SMALL)


def _np(x):
    return np.asarray(x).astype(np.int64)


def _assert_blocks_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for name, v in want.items():
        assert got[name].dtype in (torch.int32, torch.int64), name
        np.testing.assert_array_equal(_np(got[name]), _np(v), err_msg=name)


def test_pob_cs_matches_jax(jax_cs):
    cs = tpc.build_pob_cs(SMALL)
    assert (cs.num_constraints, cs.num_wires, cs.num_public) == (
        jax_cs.num_constraints, jax_cs.num_wires, jax_cs.num_public)
    assert [(b.name, b.start, b.shape) for b in cs.blocks] == [
        (b.name, b.start, b.shape) for b in jax_cs.blocks]
    got, want = cs.matrices_indexed(), jax_cs.matrices_indexed()
    for g, w in zip(got[:3], want[:3]):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert [int(c) for c in got[3]] == [int(c) for c in want[3]]


@pytest.mark.parametrize("case", range(4), ids=["fixture", "pec+1", "layer0", "layer1"])
def test_pob_witness_satisfies_jax_cs(cases, port_blocks, jax_cs, case):
    W = assemble_witness(tpc.build_pob_cs(SMALL), port_blocks)
    w = limb.limb_rows_to_ints(W[case].numpy())
    assert w[0] == 1
    assert w[1] == jinputs.pob_expected_commitment(cases[case], J_SMALL)
    assert w[1] == inputs.pob_expected_commitment(cases[case], SMALL)
    assert jax_cs.check_witness(w) == EXPECT_OK[case]


def test_keccak_bytes_trace_matches_jax():
    rng = np.random.default_rng(71)
    data = rng.integers(0, 256, (3, 272)).astype(np.int32)
    lens = np.array([5, 135, 271], np.int32)
    want_b, want_d = jax.jit(jw.keccak_bytes_trace, static_argnums=2)(
        jnp.asarray(data), jnp.asarray(lens), 2)
    got_b, got_d = tw.keccak_bytes_trace(torch.from_numpy(data), torch.from_numpy(lens), 2)
    _assert_blocks_equal(got_b, want_b)
    np.testing.assert_array_equal(_np(got_d), _np(want_d))


def test_hint_helpers_match_jax():
    rng = np.random.default_rng(72)
    a, b = rng.integers(0, 300, (2, 5, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tw.i32_sub_mod_p(torch.from_numpy(a), torch.from_numpy(b))),
        _np(jw.i32_sub_mod_p(jnp.asarray(a), jnp.asarray(b))))
    np.testing.assert_array_equal(_np(tw.int_bits(torch.from_numpy(a), 9)),
                                  _np(jw.int_bits(jnp.asarray(a), 9)))
    bits = rng.integers(0, 2, (3, 256)).astype(np.int32)
    np.testing.assert_array_equal(_np(tw.digest_bits_to_bytes(torch.from_numpy(bits))),
                                  _np(jw.digest_bits_to_bytes(jnp.asarray(bits))))
    vals = [0, 1, FR_MOD - 1, 12345, 0, 7 << 200]
    diffs = limb.ints_to_limbs(vals).reshape(3, 2, 16)
    got_z, got_inv = tw.is_zero_hints(torch.from_numpy(diffs))
    want_z, want_inv = jax.jit(jw.is_zero_hints)(jnp.asarray(diffs.astype(np.uint32)))
    np.testing.assert_array_equal(_np(got_z), _np(want_z))
    np.testing.assert_array_equal(_np(got_inv), _np(want_inv))
    inv = limb.limb_rows_to_ints(got_inv.reshape(-1, 16).numpy())
    assert [x * y % FR_MOD for x, y in zip(vals, inv)] == [int(v != 0) for v in vals]


def test_inv_mont_and_is_zero_match_jax():
    vals = [0, 1, 2, FR_MOD - 1, 3 ** 100 % FR_MOD, 1 << 250]
    a = limb.ints_to_limbs(vals)
    am = limb.to_mont(limb.FR, torch.from_numpy(a))
    got = limb.inv_mont(limb.FR, am)
    want = jax.jit(lambda x: jl.inv_mont(jl.FR, x))(jnp.asarray(_np(am).astype(np.uint32)))
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(limb.is_zero(torch.from_numpy(a)).numpy(),
                                  np.asarray(jl.is_zero(jnp.asarray(a.astype(np.uint32)))))
    back = limb.limb_rows_to_ints(limb.from_mont(limb.FR, got).numpy())
    assert back == [pow(v, FR_MOD - 2, FR_MOD) for v in vals]


def test_keccak_sponge_matches_jax():
    rng = np.random.default_rng(73)
    max_blocks = 3
    data = rng.integers(0, 256, (6, max_blocks * 136)).astype(np.int32)
    lens = np.array([0, 1, 135, 136, 271, 407], np.int32)
    pad, nb = keccak.pad_bytes(torch.from_numpy(data), torch.from_numpy(lens), max_blocks)
    jpad, jnb = jk.pad_bytes(jnp.asarray(data), jnp.asarray(lens), max_blocks)
    np.testing.assert_array_equal(_np(pad), _np(jpad))
    np.testing.assert_array_equal(_np(nb), _np(jnb))
    dig, (slo, shi) = keccak.keccak_bytes(torch.from_numpy(data), torch.from_numpy(lens),
                                          max_blocks, return_states=True)
    jdig, (jlo, jhi) = jax.jit(jk.keccak_bytes, static_argnums=(2, 3))(
        jnp.asarray(data), jnp.asarray(lens), max_blocks, True)
    np.testing.assert_array_equal(_np(dig), _np(jdig))
    np.testing.assert_array_equal(_np(slo), _np(jlo))
    np.testing.assert_array_equal(_np(shi), _np(jhi))
    for d, row, n in zip(dig, data, lens):
        assert bytes(d.tolist()) == keccak_ref.keccak256(bytes(row[:n].tolist()))
    fixed = keccak.keccak_fixed(torch.from_numpy(data[:2, :200]))
    assert [bytes(r.tolist()) for r in fixed] == [keccak_ref.keccak256(bytes(r[:200].tolist()))
                                                  for r in data[:2]]


def _layers(kwargs):
    return kwargs["layers"], kwargs["layer_lens"]


def _jax_gadget(fn, name, *args):
    """pob_tpu's gadget witness fn(blocks, name, *args), jitted (a few
    seconds of compile; eagerly it costs ~5x more): (blocks, its output)."""
    def run(*a):
        blocks = {}
        return blocks, fn(blocks, name, *a)

    return jax.jit(run)(*(jnp.asarray(np.asarray(a)) for a in args))


def test_leaf_detector_wit_matches_jax(kwargs):
    """Both layers of every case at once (the layer axis is a batch axis)."""
    layers, lens = _layers(kwargs)
    got = {}
    got_leaf = tpc._leaf_detector_wit(got, "ld", layers, lens)
    want, want_leaf = _jax_gadget(jpc._leaf_detector_wit, "ld", layers, lens)
    _assert_blocks_equal(got, want)
    np.testing.assert_array_equal(_np(got_leaf), _np(want_leaf))
    assert got_leaf.tolist() == [[0, 1], [0, 1], [0, 1], [0, 0]]


def test_substring_wit_matches_jax(kwargs):
    """On a 40-byte window of layer 0 that holds layer 1's digest at offset
    7 (pob_tpu's witness unrolls one step per offset, so the whole 408-byte
    layer costs a minute of JAX), with window lengths 40, 40, 37 (the match
    ends past it) and 40 (layer 1 corrupted)."""
    layers, lens = _layers(kwargs)
    digest = keccak.keccak_bytes(layers[:, 1], lens[:, 1], SMALL.max_node_blocks)[:, :31]
    main = layers[:, 0, 100:140].contiguous()
    main_len = torch.tensor([40, 40, 37, 40], dtype=torch.int32)
    got = {}
    found = tpc._substring_wit(got, "ss", main, main_len, digest)
    want, jfound = _jax_gadget(jpc._substring_wit, "ss", main, main_len, digest)
    _assert_blocks_equal(got, want)
    np.testing.assert_array_equal(_np(found), _np(jfound))
    assert found.tolist() == [1, 1, 0, 0]


def test_mpt_leaf_wit_matches_jax():
    rng = np.random.default_rng(74)
    nib = rng.integers(0, 16, (4, 64)).astype(np.int32)
    nib_len = np.array([63, 62, 64, 20], np.int32)
    act = limb.ints_to_limbs([10**18, 0, 127, (1 << 240) + 5])
    got = {}
    tpc._mpt_leaf_wit(got, "leaf", torch.from_numpy(nib), torch.from_numpy(nib_len),
                      torch.from_numpy(act))
    want, _ = _jax_gadget(jpc._mpt_leaf_wit, "leaf", nib, nib_len, act.astype(np.uint32))
    _assert_blocks_equal(got, want)


def test_pob_forward_matches_golden():
    """tests/test_pob.py on the port: the fixture validates with the golden
    commitment; corrupting used layers 0 or 1 rejects; corrupting unused
    layers 2 or 3 does not."""
    with open(FIX) as f:
        base = json.load(f)
    variants = [base]
    for i in range(4):
        v = copy.deepcopy(base)
        v["layers"][i][0] += 1
        variants.append(v)
    kw = inputs.to_device(inputs.batch_stack([inputs.load_pob_input(v, TEST_CONFIG)
                                              for v in variants]), "cpu")
    out = pob_forward(TEST_CONFIG, **kw)
    assert out["valid"].tolist() == [True, False, False, True, True]
    expected = inputs.pob_expected_commitment(base, TEST_CONFIG)
    assert expected == jinputs.pob_expected_commitment(base, jpob.TEST_CONFIG)
    commits = limb.limb_rows_to_ints(out["commitment"].numpy())
    assert commits[0] == commits[3] == commits[4] == expected


def test_widen_pob_input_matches_jax():
    """The fixture (TEST_CONFIG) widened to PROD_CONFIG: the same padded
    input as pob_tpu's widen_pob_input, and the same load_pob_input arrays."""
    from pob_tpu_torch.circuits.proof_of_burn import PROD_CONFIG

    with open(FIX) as f:
        base = json.load(f)
    got = inputs.widen_pob_input(base, PROD_CONFIG)
    want = jinputs.widen_pob_input(base, jpob.PROD_CONFIG)
    assert got == want
    assert len(got["layers"]) == PROD_CONFIG.max_num_layers
    assert got["layerLens"][len(base["layers"]):] == [256] * (
        PROD_CONFIG.max_num_layers - len(base["layers"]))
    g, w = inputs.load_pob_input(got, PROD_CONFIG), jinputs.load_pob_input(want, jpob.PROD_CONFIG)
    assert set(g) == set(w)
    for k in w:
        np.testing.assert_array_equal(_np(g[k]), _np(w[k]), err_msg=k)


@pytest.mark.skipif(not os.environ.get("POB_RUN_SLOW"),
                    reason="heavy: cold jit of pob_tpu's whole PoB witness (minutes)")
def test_pob_witness_blocks_match_jax(cases, port_blocks):
    kw = jinputs.batch_stack([jinputs.load_pob_input(c, J_SMALL) for c in cases])
    want = jpc.pob_r1cs_witness(J_SMALL, **{k: jnp.asarray(v) for k, v in kw.items()})
    _assert_blocks_equal(port_blocks, want)
