"""The port's host harness (pob_tpu_torch/harness/{rlp_host,pow_grind,
generate}.py) and its Spend forward (circuits/spend.py) against pob_tpu's,
on the CPU, with tolerance 0. No node is contacted: generate_live runs
against the mocked node of tests/test_gen_input.py. pob_tpu's grinder runs
its Python loop here (its native loader would rebuild native/ in place);
the port's runs both its native build and its Python loop."""

import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_gen_input import MockEth  # noqa: E402

import pob_tpu.harness.pow_grind as jpg  # noqa: E402
from pob_tpu.circuits.proof_of_burn import TEST_CONFIG as J_TEST  # noqa: E402
from pob_tpu.circuits.spend import SpendConfig as JSpendConfig  # noqa: E402
from pob_tpu.circuits.spend import spend_forward as j_spend_forward  # noqa: E402
from pob_tpu.field import limb as jl  # noqa: E402
from pob_tpu.harness import generate as jgen  # noqa: E402
from pob_tpu.harness import rlp_host as jrlp  # noqa: E402
from pob_tpu_torch.circuits import SpendConfig, spend_forward  # noqa: E402
from pob_tpu_torch.circuits.proof_of_burn import TEST_CONFIG  # noqa: E402
from pob_tpu_torch.field import limb as tl  # noqa: E402
from pob_tpu_torch.harness import generate as tgen  # noqa: E402
from pob_tpu_torch.harness import pow_grind as tpg  # noqa: E402
from pob_tpu_torch.harness import rlp_host as trlp  # noqa: E402
from pob_tpu_torch.harness.inputs import load_spend_input  # noqa: E402

torch.set_num_threads(1)
FIX = os.path.join(os.path.dirname(__file__), "fixtures")
REVEAL, EXTRA = 234, 43287974328


@pytest.fixture
def jax_python_grinder(monkeypatch):
    monkeypatch.setattr(jpg, "_LIB", None)
    monkeypatch.setattr(jpg, "_LIB_TRIED", True)


def test_rlp_equal_jax():
    cases = [b"", b"\x01", b"\x7f", b"\x80", b"dog", b"x" * 55, b"y" * 56, b"z" * 300,
             [b"cat", b"dog"], [], [[b"a"], [b"b", [b"c"]]], 0, 127, 128, 1024, 1 << 200,
             [b"q" * 60, [b"r" * 70]]]
    for c in cases:
        enc = trlp.encode(c)
        assert enc == jrlp.encode(c)
        assert trlp.decode(enc) == jrlp.decode(enc)
    for bad in (b"", b"\x01\x02"):  # empty, trailing bytes
        with pytest.raises((ValueError, IndexError)):
            jrlp.decode(bad)
        with pytest.raises((ValueError, IndexError)):
            trlp.decode(bad)


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_grind_equal_jax(jax_python_grinder, monkeypatch, native):
    if native:
        assert tpg._lib() is not None, "g++ should build native/pow_grinder.cpp here"
    else:
        monkeypatch.setattr(tpg, "_lib", lambda: None)
    key = tpg.find_burn_key(REVEAL, EXTRA, 1, start_key=1000, max_iters=5000)
    assert key == jpg.find_burn_key(REVEAL, EXTRA, 1, start_key=1000, max_iters=5000)
    assert tpg.pow_digest(key, REVEAL, EXTRA) == jpg.pow_digest(key, REVEAL, EXTRA)
    assert tpg.pow_digest(key, REVEAL, EXTRA)[:1] == b"\x00"


def test_native_grinder_builds_outside_native_dir():
    path = tpg.native_path()
    assert os.path.exists(path) and "build" in Path(path).parts
    assert Path(path).parent.parent == Path(tpg._build.BUILD)


def test_burn_address_and_leaf_equal_jax():
    with open(os.path.join(FIX, "pob_input.json")) as f:
        d = json.load(f)
    for key in (1, int(d["burnKey"]), (1 << 253) + 17):
        args = (key, int(d["revealAmount"]), int(d["burnExtraCommitment"]))
        assert tgen.burn_address(*args) == jgen.burn_address(*args)
    for i in range(d["numLayers"]):
        node = bytes(d["layers"][i][:d["layerLens"][i]])
        if i == d["numLayers"] - 1:
            assert tgen.leaf_nibble_count(node) == jgen.leaf_nibble_count(node)
        else:
            with pytest.raises(ValueError):
                tgen.leaf_nibble_count(node)
    odd = trlp.encode([b"\x3a\xbc", b"v"])  # odd hex-prefix leaf
    assert tgen.leaf_nibble_count(odd) == jgen.leaf_nibble_count(odd) == 3


def test_generate_live_equal_jax(jax_python_grinder, monkeypatch):
    import secrets

    monkeypatch.setattr(secrets, "randbelow", lambda n: 424242)
    want = jgen.generate_live(J_TEST, MockEth(), REVEAL, EXTRA, 1)
    got = tgen.generate_live(TEST_CONFIG, MockEth(), REVEAL, EXTRA, 1)
    assert json.dumps(got) == json.dumps(want)
    assert tgen.build_spend_input(1, 2, 3, 4) == jgen.build_spend_input(1, 2, 3, 4)


def test_spend_forward_equal_jax():
    base = load_spend_input(os.path.join(FIX, "spend_input.json"))
    cases = [base, dict(base, withdrawn=base["balance"] + 1),  # overdraw: invalid
             dict(base, extra_commitment=base["extra_commitment"] + 5)]
    keys = ("burn_key", "balance", "withdrawn", "extra_commitment")
    limbs = [tl.ints_to_limbs([c[k] for c in cases]) for k in keys]
    got = spend_forward(SpendConfig(), *(torch.from_numpy(a) for a in limbs))
    # jitted: op by op it takes about 25 s on the CPU, compiled about 12 s
    want = jax.jit(j_spend_forward, static_argnums=0)(
        JSpendConfig(), *(jnp.asarray(a.astype(np.uint32)) for a in limbs))
    for k in ("commitment", "coin", "remaining_coin"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["valid"].tolist() == [True, False, True]
    assert jl.limbs_to_int(np.asarray(want["commitment"])[0]) == tl.limbs_to_int(
        got["commitment"][0].numpy())


def test_graft_entry_torch_on_cpu():
    """graft_entry_torch.entry: the batch-2 PoB forward of the fixture gives
    the fixture's commitment, valid; with no card and no CPU request it
    raises rather than fall back."""
    import graft_entry_torch
    from pob_tpu_torch.harness.inputs import pob_expected_commitment

    fn, args = graft_entry_torch.entry(device="cpu")
    commitment, valid = fn(*args)
    want = pob_expected_commitment(os.path.join(FIX, "pob_input.json"), TEST_CONFIG)
    assert tl.limb_rows_to_ints(commitment.numpy()) == [want, want]
    assert valid.tolist() == [True, True]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            graft_entry_torch.entry()
