"""The seeded input generators: a generated burn, cut to TEST_CONFIG's depth
(at most 4 nodes), gives a witness that the program's CPU path makes and
check_witness accepts, with the public input the plain reference works out;
generated spends likewise; two seeds give different inputs."""

import copy
import json
import os
import random

from benchmark.configs import pob_prod_inputs, pob_prod_ref, spend_inputs, spend_ref

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def _test_config():
    """pob_prod's file with TEST_CONFIG's parameters, (4, 4, 5, 20, 31, 2,
    10**18, 10**19), and tries of 3 and 4 nodes."""
    cfg = copy.deepcopy(_cfg("pob_prod"))
    cfg.update(max_num_layers=4, max_node_blocks=4, max_header_blocks=5,
               min_leaf_address_nibbles=20, max_intended_balance=10 ** 18,
               max_actual_balance=10 ** 19)
    cfg["assumed"].update(trie_depths=[4, 3], intended_balance_wei=[10 ** 15, 10 ** 18],
                          balance_left_over_wei=10 ** 17)
    return cfg


def _check(circuit, items, public_inputs):
    from pob_tpu_torch.field import limb

    W = circuit.witness(items, "cpu")
    for b, item in enumerate(items):
        w = limb.limb_rows_to_ints(W[b].numpy())
        assert circuit.cs.check_witness(w)
        assert w[1:2] == public_inputs(item)


def test_generated_burns_prove_at_test_depth():
    from benchmark.configs import pob_prod
    from pob_tpu_torch.circuits.proof_of_burn import TEST_CONFIG

    cfg = _test_config()
    circuit = pob_prod.Circuit(cfg)
    assert circuit.pcfg == TEST_CONFIG
    rng = random.Random("2147483651:inputs")
    items = [pob_prod_inputs.fresh(b, rng) for b in pob_prod_inputs.pool(cfg, rng, 2)]
    assert sorted(b["numLayers"] for b in items) == [3, 4]
    _check(circuit, items, pob_prod_ref.public_inputs)


def test_generated_burns_at_prod_depth_have_mainnet_shapes():
    cfg = _cfg("pob_prod")
    burns = pob_prod_inputs.pool(cfg, random.Random("7:inputs"), 8)
    assert sorted(b["numLayers"] for b in burns) == sorted(cfg["assumed"]["trie_depths"])
    sizes = [n for b in burns for n in b["layerLens"][:b["numLayers"]]]
    assert max(sizes) <= 532 and 380 <= sum(sizes) / len(sizes) <= 480
    assert all(600 <= b["blockHeaderLen"] <= 700 for b in burns)
    for b in burns:
        layers = [bytes(l[:n]) for l, n in zip(b["layers"], b["layerLens"][:b["numLayers"]])]
        for parent, child in zip(layers, layers[1:]):
            assert pob_prod_inputs.keccak256(child) in parent
        header = bytes(b["blockHeader"][:b["blockHeaderLen"]])
        assert header[91:123] == pob_prod_inputs.keccak256(layers[0])


def test_generated_spends_prove():
    from benchmark.configs import spend

    cfg = _cfg("spend")
    circuit = spend.Circuit(cfg)
    rng = random.Random("2147483652:inputs")
    items = [spend_inputs.fresh(c, rng) for c in spend_inputs.pool(cfg, rng, 3)]
    _check(circuit, items, spend_ref.public_inputs)


def test_seeds_give_different_inputs():
    for gen, cfg in ((pob_prod_inputs, _test_config()), (spend_inputs, _cfg("spend"))):
        a = gen.pool(cfg, random.Random("1:inputs"), 2)
        b = gen.pool(cfg, random.Random("2:inputs"), 2)
        again = gen.pool(cfg, random.Random("1:inputs"), 2)
        assert a != b and a == again
        one = gen.fresh(a[0], random.Random(0))
        assert one != gen.fresh(a[0], random.Random(1))
