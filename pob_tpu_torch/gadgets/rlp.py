"""RLP / Merkle-Patricia-Trie gadgets (reference circuits/utils/rlp/*).

All functions are batched over leading axes; `ok` flags collect the
circom-side assertions so circuits can reject invalid witnesses."""

from __future__ import annotations

import numpy as np
import torch

from ..field import limb
from .bytesops import (
    I32,
    concat,
    count_bytes,
    limb_lt,
    limbs_to_be_bytes_checked,
    nibbles_to_bytes,
    selector,
    shift_left,
)

# RLP(storage_hash) + RLP(code_hash) of an empty account, 66 bytes
# (rlp/empty_account.circom:51-120): 0xa0 || keccak256(rlp(0)) snapshot of the
# empty storage trie root, 0xa0 || keccak256(b"") code hash.
EMPTY_STORAGE_HASH = bytes.fromhex(
    "56e81f171bcc55a6ff8345e692c0f86e5b48e01b996cadc001622fb5e363b421"
)
EMPTY_CODE_HASH = bytes.fromhex(
    "c5d2460186f7233c927e7db2dcc703c0e500b653ca82273b7bfad8045d85a470"
)
_STORAGE_CODE_RLP = np.concatenate(
    [
        np.array([0xA0], np.int32),
        np.frombuffer(EMPTY_STORAGE_HASH, np.uint8).astype(np.int32),
        np.array([0xA0], np.int32),
        np.frombuffer(EMPTY_CODE_HASH, np.uint8).astype(np.int32),
    ]
)  # (66,)


def _full(batch, value: int, like):
    return torch.full(batch + (1,), value, dtype=I32, device=like.device)


def rlp_integer(value_limbs, n: int):
    """RlpInteger (rlp/integer.circom:67-110): RLP of an integer < 2^(8n),
    n <= 31. Returns (out (..., n+1), out_len, ok)."""
    assert n <= 31
    be, ok_range = limbs_to_be_bytes_checked(value_limbs, n)  # (..., n)
    length = count_bytes(be)
    big_endian, ok_shift = shift_left(be, n - length)
    is_single = limb_lt(value_limbs,
                        limb.small_to_limbs(torch.full_like(length, 128)))
    is_zero = limb.is_zero(value_limbs).to(I32)
    first = torch.where(is_single, be[..., -1], 0x80 + length) + is_zero * 0x80
    rest = torch.where(is_single[..., None], 0, big_endian)
    out = torch.cat([first[..., None], rest], -1)
    out_len = (~is_single).to(I32) + length + is_zero
    return out, out_len, ok_range & ok_shift


def rlp_empty_account(balance_limbs, max_balance_bytes: int):
    """RlpEmptyAccount (rlp/empty_account.circom:20-134):
    RLP([0, balance, EMPTY_STORAGE_HASH, EMPTY_CODE_HASH]).
    Returns (out (..., 4+max_balance_bytes+66), out_len, ok)."""
    assert max_balance_bytes <= 31
    bal_rlp, bal_rlp_len, ok = rlp_integer(balance_limbs, max_balance_bytes)
    nonce_and_balance_len = 1 + bal_rlp_len
    batch = bal_rlp.shape[:-1]
    # [0xf8, total, 0x80 (nonce), balanceRlp...]
    head = torch.cat([_full(batch, 0xF8, bal_rlp), (nonce_and_balance_len + 66)[..., None],
                      _full(batch, 0x80, bal_rlp), bal_rlp], -1)
    tail = torch.as_tensor(_STORAGE_CODE_RLP, device=bal_rlp.device).expand(batch + (66,))
    out, out_len, ok2 = concat(head, 2 + nonce_and_balance_len, tail,
                               torch.full_like(bal_rlp_len, 66))
    return out, out_len, ok & ok2


def truncated_address_hash(nibbles, nibbles_len, address_hash_bytes: int = 32):
    """TruncatedAddressHash (rlp/merkle_patricia_trie_leaf.circom:50-90):
    hex-prefix encode the LAST `nibbles_len` nibbles.
    Returns (out (..., address_hash_bytes+1), out_len, ok)."""
    two_n = 2 * address_hash_bytes
    ok = (nibbles_len >= 0) & (nibbles_len <= two_n)
    shifted, ok_shift = shift_left(nibbles, two_n - nibbles_len)
    div, rem = nibbles_len // 2, nibbles_len % 2
    # middle nibbles: shifted[i+1] if odd else shifted[i], for i < 2n-1
    mid = torch.where(rem[..., None] == 1, shifted[..., 1:], shifted[..., :-1])
    out_nibbles = torch.cat([(2 + rem)[..., None], (rem * shifted[..., 0])[..., None], mid,
                             ((1 - rem) * shifted[..., -1])[..., None]], -1)  # (..., 2n + 2)
    out, ok_nib = nibbles_to_bytes(out_nibbles)
    return out, 1 + div, ok & ok_shift & ok_nib


def mpt_leaf(nibbles, nibbles_len, balance_limbs, max_balance_bytes: int,
             max_address_hash_bytes: int = 32):
    """RlpMerklePatriciaTrieLeaf (rlp/merkle_patricia_trie_leaf.circom:102-189):
    the full account leaf RLP([key, RLP(account)]).
    Returns (out (..., maxOutLen), out_len, ok). With (32, 31): maxOutLen=139."""
    key, key_len, ok_key = truncated_address_hash(nibbles, nibbles_len,
                                                  max_address_hash_bytes)
    ok = ok_key & (key_len >= 2)  # AssertGreaterEqThan(keyLen, 2) (:151)
    account, account_len, ok_acc = rlp_empty_account(balance_limbs, max_balance_bytes)
    batch = key.shape[:-1]
    value_rlp = torch.cat([_full(batch, 0xB8, key), account_len[..., None], account], -1)
    value_rlp_len = 2 + account_len
    prefixed_key = torch.cat([_full(batch, 0xF8, key), ((key_len + 1) + value_rlp_len)[..., None],
                              (0x80 + key_len)[..., None], key], -1)  # (..., 3 + max_key_len)
    out, out_len, ok_cat = concat(prefixed_key, 3 + key_len, value_rlp, value_rlp_len)
    return out, out_len, ok & ok_acc & ok_cat


def leaf_detector(layer, layer_len):
    """LeafDetector (rlp/merkle_patricia_trie_leaf.circom:247-294): boolean
    'parses as an account leaf'. Returns (is_leaf (...,) int32, ok)."""
    n = layer.shape[-1]
    ok = (layer_len >= 0) & (layer_len <= n)
    key_prefix = layer[..., 2]
    key_multi_byte = (key_prefix >= 0x81) & (key_prefix <= 0xB7)
    key_len = 1 + torch.where(key_multi_byte, key_prefix - 0x80, 0)
    vw_prefix, ok1 = selector(layer, 2 + key_len)
    vw_len, ok2 = selector(layer, 2 + key_len + 1)
    v_prefix, ok3 = selector(layer, 2 + key_len + 2)
    v_len, ok4 = selector(layer, 2 + key_len + 3)
    is_leaf = (
        (layer[..., 0] == 0xF8)
        & ((layer[..., 1] + 2) == layer_len)
        & (key_prefix <= 0xB7)
        & (vw_prefix == 0xB8)
        & (vw_len == v_len + 2)
        & (v_prefix == 0xF8)
        & ((key_len + v_len + 6) == layer_len)
    )
    return is_leaf.to(I32), ok & ok1 & ok2 & ok3 & ok4
