"""ProofOfBurn circuit (reference circuits/proof_of_burn.circom:34-212):
prove an account with a poseidon-derived burn address and a given balance
exists in a block's state trie, revealing only a keccak commitment.

Batched forward: every MPT layer of every proof instance is hashed at once
(the layer axis is one more batch axis of the keccak permutation)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field import limb
from ..field.limb import FR
from ..gadgets.bytesops import (
    I32,
    filter_mask,
    fits_bits_i32,
    is_byte_string,
    limb_fits_bits,
    limb_leq,
    limbs_to_be_bytes_checked,
    selector,
    selector_array,
)
from ..gadgets.rlp import leaf_detector, mpt_leaf
from ..gadgets.substring import substring_check
from ..hash import keccak as kdev
from ..hash.poseidon_params import POSEIDON_COIN_PREFIX, POSEIDON_NULLIFIER_PREFIX
from .common import burn_address_hash, const_limbs, poseidon_fixed, pow_check, public_commitment

STATE_ROOT_OFFSET = 91  # stateRoot byte offset in the RLP block header (:126)
MAX_LEAF_LEN = 139  # RlpMerklePatriciaTrieLeaf(32, 31) output size (:195)


@dataclass(frozen=True)
class PoBConfig:
    """Template parameters (proof_of_burn.circom:34). Prod instantiation:
    ProofOfBurn(16, 4, 16, 50, 31, 2, 10**19, 10**20) (main_proof_of_burn.circom:26);
    test instantiation: (4, 4, 5, 20, 31, 2, 10**18, 10**19)
    (tests/testcases/proof_of_burn.py:54)."""

    max_num_layers: int = 16
    max_node_blocks: int = 4
    max_header_blocks: int = 16
    min_leaf_address_nibbles: int = 50
    amount_bytes: int = 31
    pow_minimum_zero_bytes: int = 2
    max_intended_balance: int = 10**19
    max_actual_balance: int = 10**20

    def __post_init__(self):
        if self.amount_bytes > 31:
            raise ValueError("amount_bytes must be at most 31")

    @property
    def max_node_bytes(self) -> int:
        return self.max_node_blocks * kdev.RATE

    @property
    def max_header_bytes(self) -> int:
        return self.max_header_blocks * kdev.RATE


PROD_CONFIG = PoBConfig()
TEST_CONFIG = PoBConfig(4, 4, 5, 20, 31, 2, 10**18, 10**19)


def pob_forward(
    cfg: PoBConfig,
    burn_key,  # (..., 16) limb scalar (secret)
    actual_balance,  # (..., 16)
    intended_balance,  # (..., 16)
    reveal_amount,  # (..., 16)
    burn_extra_commitment,  # (..., 16)
    num_leaf_address_nibbles,  # (...,) int
    layers,  # (..., maxNumLayers, maxNodeBytes) int32 bytes
    layer_lens,  # (..., maxNumLayers) int
    num_layers,  # (...,) int
    block_header,  # (..., maxHeaderBytes) int32 bytes
    block_header_len,  # (...,) int
    byte_security_relax,  # (...,) int
    proof_extra_commitment,  # (..., 16)
):
    """Returns a dict with `commitment`, `nullifier`, `remaining_coin` (limb
    scalars) and `valid`, the AND of every in-circuit assertion. All tensors
    on one device (the card's through the entry points)."""
    bits = cfg.amount_bytes * 8
    batch = burn_key.shape[:-1]
    dev = burn_key.device
    relax = byte_security_relax
    nibbles_len = num_leaf_address_nibbles

    # ---- input validations (:84-106) ----
    max_int_bal = const_limbs(cfg.max_intended_balance, batch, dev)
    max_act_bal = const_limbs(cfg.max_actual_balance, batch, dev)
    ok = (
        limb_fits_bits(intended_balance, bits)
        & limb_leq(intended_balance, max_int_bal)
        & limb_fits_bits(actual_balance, bits)
        & limb_leq(actual_balance, max_act_bal)
        & limb_leq(intended_balance, actual_balance)
    )
    ok = ok & fits_bits_i32(relax * 2, 16) & (relax * 2 <= cfg.min_leaf_address_nibbles)
    ok = ok & fits_bits_i32(nibbles_len, 16) & (
        nibbles_len >= cfg.min_leaf_address_nibbles - 2 * relax)
    ok = ok & limb_fits_bits(reveal_amount, bits) & limb_leq(reveal_amount, intended_balance)
    # layer lens < maxNodeBytes*8 and all layer bytes are bytes (:99-103);
    # (the *8 mirrors the reference's loose bound: the keccak gadget's own
    # inLen < maxNodeBytes check below is the tight one)
    ok = ok & ((layer_lens >= 0) & (layer_lens < cfg.max_node_bytes * 8)).all(-1)
    ok = ok & is_byte_string(layers.flatten(-2))
    ok = ok & (block_header_len >= 0) & (block_header_len < cfg.max_header_bytes * 8)
    ok = ok & is_byte_string(block_header)
    # KeccakBytes' own AssertLessThan(inLen, maxBlocks*136) (keccak.circom:460)
    ok = ok & (layer_lens < cfg.max_node_bytes).all(-1)
    ok = ok & (block_header_len < cfg.max_header_bytes)

    # ---- derived secrets (:113-119) ----
    remaining_coin = poseidon_fixed([const_limbs(POSEIDON_COIN_PREFIX, batch, dev), burn_key,
                                     limb.sub(FR, intended_balance, reveal_amount)])
    nullifier = poseidon_fixed([const_limbs(POSEIDON_NULLIFIER_PREFIX, batch, dev), burn_key])
    addr_nibbles = burn_address_hash(burn_key, reveal_amount, burn_extra_commitment)

    # ---- block root & state root (:122-129) ----
    block_root = kdev.keccak_bytes(block_header, block_header_len, cfg.max_header_blocks)
    state_root = block_header[..., STATE_ROOT_OFFSET:STATE_ROOT_OFFSET + 32]

    # ---- public commitment (:132-139) ----
    vals = [block_root]
    for v in (nullifier, remaining_coin, reveal_amount, burn_extra_commitment,
              proof_extra_commitment):
        b, ok_b = limbs_to_be_bytes_checked(v, 32)
        ok = ok & ok_b
        vals.append(b)
    commitment, ok_c = public_commitment(torch.stack(vals, -2))
    ok = ok & ok_c

    # ---- last layer (:142-146) ----
    last_layer, ok_s1 = selector_array(layers, num_layers - 1)
    last_layer_len, ok_s2 = selector(layer_lens, num_layers - 1)
    ok = ok & ok_s1 & ok_s2

    # ---- per-layer hashing & substring chain (:150-181) ----
    layer_exists = filter_mask(num_layers, cfg.max_num_layers)  # (..., maxL)
    is_leaf, ok_ld = leaf_detector(layers, layer_lens)  # batched over the layer axis
    ok = ok & ok_ld.all(-1)
    layer_keccaks = kdev.keccak_bytes(layers, layer_lens, cfg.max_node_blocks)
    reduced = layer_keccaks[..., :31]  # Fit(32, 31) (:166)
    found, ok_sub = substring_check(layers[..., :-1, :], layer_lens[..., :-1],
                                    reduced[..., 1:, :])  # (..., maxL-1)
    ok = ok & ok_sub.all(-1)
    # (1 - substringChecker) * layerExists === 0 (:179)
    ok = ok & ((found == 1) | (layer_exists[..., 1:] == 0)).all(-1)

    # ---- exactly one leaf, and it is the last layer (:186-188) ----
    ok = ok & (is_leaf.sum(-1) == 1)
    last_is_leaf, ok_ld2 = leaf_detector(last_layer, last_layer_len)
    ok = ok & ok_ld2 & (last_is_leaf == 1)

    # ---- top layer hashes to the state root (:191-193) ----
    ok = ok & (layer_keccaks[..., 0, :] == state_root).all(-1)

    # ---- recomputed leaf equals the last layer (:195-206) ----
    leaf, leaf_len, ok_leaf = mpt_leaf(addr_nibbles, nibbles_len, actual_balance,
                                       cfg.amount_bytes)
    ok = ok & ok_leaf
    ok = ok & (leaf == last_layer[..., :MAX_LEAF_LEN]).all(-1)
    ok = ok & (leaf_len == last_layer_len)

    # ---- proof of work (:211) ----
    ok = ok & pow_check(burn_key, reveal_amount, burn_extra_commitment,
                        cfg.pow_minimum_zero_bytes + relax)

    return {"commitment": commitment, "nullifier": nullifier,
            "remaining_coin": remaining_coin, "valid": ok}
