"""ProofOfBurn circuit as an R1CS: constraint builder + tensor witness
generator (statement identical to circuits/proof_of_burn.circom:34-212; the
encoding: one-hot selections instead of IsEqual chains, symbolic linear
layers, polynomial-packed substring check as in the reference).

Like the Spend system (spend_circuit.py), every witness block is a tensor the
batched witness generator produces; names/shapes form the contract, verified
by ConstraintSystem.check_witness in tests. The witness runs on the device of
its input tensors (field operations through K1 on a CUDA tensor)."""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as tf

from ..field import limb
from ..field.limb import FR
from ..field.ref import FR_MOD
from ..circuits.common import _POW_TAIL, const_limbs
from ..circuits.proof_of_burn import MAX_LEAF_LEN, STATE_ROOT_OFFSET, PoBConfig
from ..gadgets.rlp import _STORAGE_CODE_RLP, rlp_empty_account, rlp_integer
from ..hash.poseidon_params import (
    POSEIDON_BURN_ADDRESS_PREFIX,
    POSEIDON_COIN_PREFIX,
    POSEIDON_NULLIFIER_PREFIX,
)
from ..utils.metrics import traced
from .builder import ConstraintSystem
from .gadgets_cs import (
    bits_lc,
    constrain_boolean,
    constrain_decomposition,
    constrain_linear_zero,
    digest_bits_to_byte_lcs,
    is_zero_cs,
    keccak_bytes_cs,
    keccak_static_cs,
    lt_bit_cs,
    mul_lc,
    mult_and_cs,
    one_hot_cs,
    poseidon_cs,
    prefix_filter_cs,
    strict_bits_cs,
)
from .lc import lc_add, lc_const, lc_scale, lc_sub, lc_terms, lc_wire
from . import witness as wit

I32 = torch.int32


# ---------------------------------------------------------------------------
# CS-side sub-gadgets
# ---------------------------------------------------------------------------


def _dec(cs, name, lc, width):
    bits = cs.alloc_block(name, (width,), width=1)
    constrain_decomposition(cs, lc, bits)
    return bits


def _value_byte_lc(bits_arr, j: int, width: int):
    """Big-endian byte j (of 32) of a bit-decomposed value."""
    parts = []
    for k in range(8):
        b = 8 * (31 - j) + k
        if b < width:
            parts.append(lc_scale(lc_wire(int(bits_arr[b])), 1 << k))
    return lc_add(*parts) if parts else lc_const(0)


def _value_bit_lc(bits_arr, b: int, width: int):
    return lc_wire(int(bits_arr[b])) if b < width else lc_const(0)


def select_at_offset_cs(cs, name, vec_lcs, oh, k: int):
    """sum_j oh[j] * vec[j + k] via partial-product wires; returns value LC."""
    n = len(vec_lcs)
    part = cs.alloc_block(name, (len(oh),))
    for j in range(len(oh)):
        if j + k < n:
            cs.add([(int(oh[j]), 1)], lc_terms(vec_lcs[j + k]), [(int(part[j]), 1)])
        else:
            constrain_linear_zero(cs, lc_wire(int(part[j])))
    return lc_add(*[lc_wire(int(w)) for w in part])


def leaf_detector_cs(cs: ConstraintSystem, name: str, layer_lcs, len_lc):
    """LeafDetector (merkle_patricia_trie_leaf.circom:247-294) as a bit LC.
    layer bytes must already be range-checked."""
    n = len(layer_lcs)
    iza = is_zero_cs(
        cs, f"{name}_iza",
        [lc_sub(layer_lcs[0], lc_const(0xF8)),
         lc_sub(lc_add(layer_lcs[1], lc_const(2)), len_lc)],
    )
    prefix_is_f8 = lc_wire(int(iza[0]))
    consistent = lc_wire(int(iza[1]))
    kp = layer_lcs[2]
    kp_leq_b7 = lt_bit_cs(cs, f"{name}_ltb8", kp, lc_const(0xB8), 16)
    kp_leq_80 = lt_bit_cs(cs, f"{name}_lt81", kp, lc_const(0x81), 16)
    gt_80 = lc_sub(lc_const(1), kp_leq_80)
    multi = cs.alloc_block(f"{name}_multi", (2,))  # [keyIsMultiByte, keyExtraLen]
    mul_lc(cs, int(multi[0]), gt_80, kp_leq_b7)
    mul_lc(cs, int(multi[1]), lc_wire(int(multi[0])), lc_sub(kp, lc_const(0x80)))
    key_len = lc_add(lc_const(1), lc_wire(int(multi[1])))

    oh = one_hot_cs(cs, f"{name}_oh", n, lc_add(lc_const(2), key_len))
    vw = select_at_offset_cs(cs, f"{name}_p0", layer_lcs, oh, 0)
    vw_len = select_at_offset_cs(cs, f"{name}_p1", layer_lcs, oh, 1)
    vp = select_at_offset_cs(cs, f"{name}_p2", layer_lcs, oh, 2)
    v_len = select_at_offset_cs(cs, f"{name}_p3", layer_lcs, oh, 3)

    izb = is_zero_cs(
        cs, f"{name}_izb",
        [lc_sub(vw, lc_const(0xB8)),
         lc_sub(vw_len, lc_add(v_len, lc_const(2))),
         lc_sub(vp, lc_const(0xF8)),
         lc_sub(lc_add(key_len, lc_add(v_len, lc_const(6))), len_lc)],
    )
    return mult_and_cs(
        cs, f"{name}_and",
        [prefix_is_f8, consistent, kp_leq_b7,
         lc_wire(int(izb[0])), lc_wire(int(izb[1])),
         lc_wire(int(izb[2])), lc_wire(int(izb[3]))],
    )


def substring_cs(cs: ConstraintSystem, name: str, main_lcs, main_len_lc, sub_lcs):
    """SubstringCheck(maxMainLen, 31) (substring_check.circom:24-99) with the
    reference's polynomial-packing trick; returns the boolean output LC.
    main/sub bytes must already be range-checked."""
    n = len(main_lcs)
    sub_len = len(sub_lcs)
    n_off = n - sub_len + 1
    _dec(cs, f"{name}_geq", lc_sub(main_len_lc, lc_const(sub_len)), 16)

    sub_num = lc_add(*[lc_scale(sub_lcs[i], pow(256, i, FR_MOD)) for i in range(sub_len)])

    m = cs.alloc_block(f"{name}_M", (n,))  # m[j] = M[j+1]
    constrain_linear_zero(cs, lc_sub(lc_wire(int(m[0])), main_lcs[0]))
    for j in range(1, n):
        constrain_linear_zero(
            cs,
            lc_sub(
                lc_wire(int(m[j])),
                lc_add(lc_wire(int(m[j - 1])), lc_scale(main_lcs[j], pow(256, j, FR_MOD))),
            ),
        )

    def m_at(k):  # M[k]
        return lc_const(0) if k == 0 else lc_wire(int(m[k - 1]))

    diffs = [
        lc_sub(lc_scale(sub_num, pow(256, i, FR_MOD)), lc_sub(m_at(i + sub_len), m_at(i)))
        for i in range(n_off)
    ]
    exists = is_zero_cs(cs, f"{name}_ex", diffs)

    oh = one_hot_cs(cs, f"{name}_oh", n_off, lc_sub(main_len_lc, lc_const(sub_len - 1)))
    allowed = prefix_filter_cs(cs, f"{name}_alw", oh)
    sums = cs.alloc_block(f"{name}_sums", (n_off,))
    prev = lc_const(0)
    for i in range(n_off):
        cs.add(
            [(int(allowed[i]), 1)],
            [(int(exists[i]), 1)],
            lc_terms(lc_sub(lc_wire(int(sums[i])), prev)),
        )
        prev = lc_wire(int(sums[i]))
    dz = is_zero_cs(cs, f"{name}_dz", [prev])
    return lc_sub(lc_const(1), lc_wire(int(dz[0])))


def mpt_leaf_cs(cs: ConstraintSystem, name: str, nib_lcs, nib_len_lc,
                balance_lc, balance_bits, amount_bytes: int = 31):
    """RlpMerklePatriciaTrieLeaf(32, amount_bytes) (rlp/merkle_patricia_trie_
    leaf.circom:102-189). Returns (139 byte LCs, leaf_len LC). nib_lcs are
    structurally 4-bit (digest-derived)."""
    assert amount_bytes == 31, "prod/test configs use 31-byte amounts"
    # AssertLessEqThan(7)(len, 64)
    _dec(cs, f"{name}_len7", nib_len_lc, 7)
    _dec(cs, f"{name}_lenmax", lc_sub(lc_const(64), nib_len_lc), 7)
    # ShiftLeft(64)(nibbles, 64 - len)
    ohc = one_hot_cs(cs, f"{name}_shoh", 65, lc_sub(lc_const(64), nib_len_lc))
    shp = cs.alloc_block(f"{name}_shp", (65, 64), width=4)
    for j in range(65):
        for i in range(64):
            if i + j < 64:
                cs.add([(int(ohc[j]), 1)], lc_terms(nib_lcs[i + j]), [(int(shp[j, i]), 1)])
            else:
                constrain_linear_zero(cs, lc_wire(int(shp[j, i])))
    shifted = [lc_add(*[lc_wire(int(shp[j, i])) for j in range(65)]) for i in range(64)]
    # div/rem of len by 2
    rem = cs.alloc_block(f"{name}_rem", (1,), width=1)
    constrain_boolean(cs, rem)
    rem_lc = lc_wire(int(rem[0]))
    div = cs.alloc_block(f"{name}_div", (1,))
    div_lc = lc_wire(int(div[0]))
    _dec(cs, f"{name}_div_bits", div_lc, 6)
    constrain_linear_zero(cs, lc_sub(nib_len_lc, lc_add(lc_scale(div_lc, 2), rem_lc)))
    # outNibbles (66): [2+rem, rem*shifted[0], mux..., (1-rem)*shifted[63]]
    on1 = cs.alloc_block(f"{name}_on1", (1,))
    cs.add(lc_terms(rem_lc), lc_terms(shifted[0]), [(int(on1[0]), 1)])
    mid = cs.alloc_block(f"{name}_mid", (63,))
    mid_lcs = []
    for i in range(63):
        # m = shifted[i] + rem*(shifted[i+1] - shifted[i])
        cs.add(lc_terms(rem_lc), lc_terms(lc_sub(shifted[i + 1], shifted[i])),
               lc_terms(lc_sub(lc_wire(int(mid[i])), shifted[i])))
        mid_lcs.append(lc_wire(int(mid[i])))
    onl = cs.alloc_block(f"{name}_onl", (1,))
    cs.add(lc_terms(lc_sub(lc_const(1), rem_lc)), lc_terms(shifted[63]), [(int(onl[0]), 1)])
    out_nib = (
        [lc_add(lc_const(2), rem_lc), lc_wire(int(on1[0]))] + mid_lcs + [lc_wire(int(onl[0]))]
    )  # 66 nibbles
    key = [lc_add(lc_scale(out_nib[2 * i], 16), out_nib[2 * i + 1]) for i in range(33)]
    key_len = lc_add(lc_const(1), div_lc)
    _dec(cs, f"{name}_kl2", lc_sub(key_len, lc_const(2)), 7)  # keyLen >= 2 (:151)

    # RlpInteger(31)(balance) (rlp/integer.circom:67-110)
    bal_bytes = [_value_byte_lc(balance_bits, j + 1, 248) for j in range(31)]
    bz = is_zero_cs(cs, f"{name}_bz", bal_bytes)
    sz = cs.alloc_block(f"{name}_sz", (31,), width=1)
    constrain_linear_zero(cs, lc_sub(lc_wire(int(sz[0])), lc_wire(int(bz[0]))))
    for i in range(1, 31):
        cs.add([(int(bz[i]), 1)], [(int(sz[i - 1]), 1)], [(int(sz[i]), 1)])
    length = lc_sub(lc_const(31), lc_add(*[lc_wire(int(w)) for w in sz]))
    oh32 = one_hot_cs(cs, f"{name}_rloh", 32, lc_sub(lc_const(31), length))
    rlshp = cs.alloc_block(f"{name}_rlshp", (32, 31))
    for j in range(32):
        for i in range(31):
            if i + j < 31:
                cs.add([(int(oh32[j]), 1)], lc_terms(bal_bytes[i + j]), [(int(rlshp[j, i]), 1)])
            else:
                constrain_linear_zero(cs, lc_wire(int(rlshp[j, i])))
    big_endian = [lc_add(*[lc_wire(int(rlshp[j, i])) for j in range(32)]) for i in range(31)]
    is_single = lt_bit_cs(cs, f"{name}_lt128", balance_lc, lc_const(128), 248)
    balz = is_zero_cs(cs, f"{name}_balz", [balance_lc])
    balz_lc = lc_wire(int(balz[0]))
    # first = (0x80 + length) + isSingle*(lastByte - 0x80 - length)
    first = cs.alloc_block(f"{name}_first", (1,))
    cs.add(
        lc_terms(is_single),
        lc_terms(lc_sub(bal_bytes[30], lc_add(lc_const(0x80), length))),
        lc_terms(lc_sub(lc_wire(int(first[0])), lc_add(lc_const(0x80), length))),
    )
    out0 = lc_add(lc_wire(int(first[0])), lc_scale(balz_lc, 0x80))
    rest = cs.alloc_block(f"{name}_rest", (31,))
    for i in range(31):
        cs.add(lc_terms(lc_sub(lc_const(1), is_single)), lc_terms(big_endian[i]),
               [(int(rest[i]), 1)])
    bal_rlp = [out0] + [lc_wire(int(rest[i])) for i in range(31)]  # 32 bytes
    bal_rlp_len = lc_add(lc_sub(lc_const(1), is_single), lc_add(length, balz_lc))

    # RlpEmptyAccount (rlp/empty_account.circom:20-134): head + const tail
    nb_len = lc_add(lc_const(1), bal_rlp_len)
    prefixed_len = lc_add(lc_const(2), nb_len)  # in [4, 35]
    head = [lc_const(0xF8), lc_add(nb_len, lc_const(66)), lc_const(0x80)] + bal_rlp  # 35
    ohacc = one_hot_cs(cs, f"{name}_accoh", 36, prefixed_len)
    tail = [int(v) for v in _STORAGE_CODE_RLP]
    account = []
    for i in range(101):
        parts = [head[i]] if i < 35 else []
        for j in range(36):
            t = i - j
            if 0 <= t < 66 and tail[t]:
                parts.append(lc_scale(lc_wire(int(ohacc[j])), tail[t]))
        account.append(lc_add(*parts) if parts else lc_const(0))
    account_len = lc_add(prefixed_len, lc_const(66))

    # leaf = RLP([key, value]): value = [0xb8, accountLen, account] (103)
    val = [lc_const(0xB8), account_len] + account
    val_len = lc_add(lc_const(2), account_len)
    pk = [lc_const(0xF8), lc_add(lc_add(key_len, lc_const(1)), val_len),
          lc_add(lc_const(0x80), key_len)] + key  # 36
    pk_len = lc_add(lc_const(3), key_len)  # in [5, 36]
    ohpk = one_hot_cs(cs, f"{name}_pkoh", 37, pk_len)
    vp = cs.alloc_block(f"{name}_vp", (37, 103))
    for j in range(37):
        for t in range(103):
            cs.add([(int(ohpk[j]), 1)], lc_terms(val[t]), [(int(vp[j, t]), 1)])
    leaf = []
    for i in range(MAX_LEAF_LEN):
        parts = [pk[i]] if i < 36 else []
        for j in range(37):
            t = i - j
            if 0 <= t < 103:
                parts.append(lc_wire(int(vp[j, t])))
        leaf.append(lc_add(*parts) if parts else lc_const(0))
    leaf_len = lc_add(pk_len, val_len)
    return leaf, leaf_len


# ---------------------------------------------------------------------------
# top-level builder
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def build_pob_cs(cfg: PoBConfig) -> ConstraintSystem:
    L, NB, HB = cfg.max_num_layers, cfg.max_node_bytes, cfg.max_header_bytes
    min_leaf = cfg.min_leaf_address_nibbles
    cs = ConstraintSystem()
    pub = cs.alloc_block("pub", (1,))
    cs.mark_public(1)
    sc = cs.alloc_block("scalars", (10,))
    bk, act, inten, rev, bex, nib_len, nlay, hlen, relax, pex = (
        lc_wire(int(w)) for w in sc
    )
    layers_w = cs.alloc_block("layers", (L, NB), width=8)
    lens_w = cs.alloc_block("layer_lens", (L,))
    hdr_w = cs.alloc_block("header", (HB,), width=8)
    layer_lcs = [[lc_wire(int(w)) for w in layers_w[i]] for i in range(L)]
    hdr_lcs = [lc_wire(int(w)) for w in hdr_w]
    len_lcs = [lc_wire(int(w)) for w in lens_w]

    # ---- input validations (proof_of_burn.circom:84-106) ----
    _dec(cs, "v_int", inten, 248)
    act_bits = _dec(cs, "v_act", act, 248)
    rev_bits = _dec(cs, "v_rev", rev, 248)
    _dec(cs, "v_int_max", lc_sub(lc_const(cfg.max_intended_balance), inten), 248)
    _dec(cs, "v_act_max", lc_sub(lc_const(cfg.max_actual_balance), act), 248)
    _dec(cs, "v_int_act", lc_sub(act, inten), 248)
    _dec(cs, "v_rev_int", lc_sub(inten, rev), 248)
    relax2 = lc_scale(relax, 2)
    _dec(cs, "v_relax2", relax2, 16)
    _dec(cs, "v_relax_min", lc_sub(lc_const(min_leaf), relax2), 16)
    _dec(cs, "v_nib", nib_len, 16)
    _dec(cs, "v_nib_min", lc_sub(nib_len, lc_sub(lc_const(min_leaf), relax2)), 16)
    for i in range(L):
        _dec(cs, f"v_len{i}", len_lcs[i], 16)
        _dec(cs, f"v_lenmax{i}", lc_sub(lc_const(NB * 8 - 1), len_lcs[i]), 16)
    _dec(cs, "v_hlen", hlen, 16)
    _dec(cs, "v_hlenmax", lc_sub(lc_const(HB * 8 - 1), hlen), 16)
    # AssertByteString on every layer/header byte (:100-105)
    lb = cs.alloc_block("layer_bits", (L, NB, 8), width=1)
    constrain_boolean(cs, lb)
    for i in range(L):
        for j in range(NB):
            constrain_linear_zero(cs, lc_sub(bits_lc(lb[i, j]), layer_lcs[i][j]))
    hb = cs.alloc_block("header_bits", (HB, 8), width=1)
    constrain_boolean(cs, hb)
    for j in range(HB):
        constrain_linear_zero(cs, lc_sub(bits_lc(hb[j]), hdr_lcs[j]))

    # ---- derived secrets (:113-119) ----
    remaining = poseidon_cs(cs, "p_coin", [lc_const(POSEIDON_COIN_PREFIX), bk, lc_sub(inten, rev)])
    nullifier = poseidon_cs(cs, "p_null", [lc_const(POSEIDON_NULLIFIER_PREFIX), bk])
    addr_h = poseidon_cs(cs, "p_addr", [lc_const(POSEIDON_BURN_ADDRESS_PREFIX), bk, rev, bex])
    addr_bits = _dec(cs, "addr_bits", addr_h, 254)
    strict_bits_cs(cs, "addr_bits", addr_bits)

    # burn-address keccak (static 1 block, inLen=20; burn_address.circom:67-83)
    def addr_msg_bit(byte, k):
        if byte < 20:
            return _value_bit_lc(addr_bits, 8 * (31 - byte) + k, 254)
        if byte == 20 and k == 0:
            return lc_const(1)
        if byte == 135 and k == 7:
            return lc_const(1)
        return lc_const(0)

    ah_bits = keccak_static_cs(
        cs, "k_addr", [addr_msg_bit(b, k) for b in range(136) for k in range(8)], 1
    )
    nib_lcs = []
    for i in range(32):
        hi_n = lc_add(*[lc_scale(ah_bits[8 * i + 4 + k], 1 << k) for k in range(4)])
        lo_n = lc_add(*[lc_scale(ah_bits[8 * i + k], 1 << k) for k in range(4)])
        nib_lcs.extend([hi_n, lo_n])

    # block root (dynamic keccak over the header) + state root (:122-129)
    blockroot_bits = keccak_bytes_cs(cs, "k_hdr", hdr_lcs, hlen, cfg.max_header_blocks)

    # public commitment (:132-139): 6 values, 192 bytes, 2 static blocks
    # full-width decompositions carry the Num2Bits_strict alias check
    # (convert.circom:46-56) — they feed keccak messages (commitment, PoW,
    # burn address), so a non-canonical x + p encoding would bind a different
    # message to the same field values.
    null_bits = _dec(cs, "null_bits", nullifier, 254)
    strict_bits_cs(cs, "null_bits", null_bits)
    coin_bits = _dec(cs, "coin_bits", remaining, 254)
    strict_bits_cs(cs, "coin_bits", coin_bits)
    bex_bits = _dec(cs, "bex_bits", bex, 254)
    strict_bits_cs(cs, "bex_bits", bex_bits)
    pex_bits = _dec(cs, "pex_bits", pex, 254)
    strict_bits_cs(cs, "pex_bits", pex_bits)
    bk_bits = _dec(cs, "bk_bits", bk, 254)
    strict_bits_cs(cs, "bk_bits", bk_bits)

    def com_msg_bit(byte, k):
        if byte < 192:
            v, j = divmod(byte, 32)
            if v == 0:
                return blockroot_bits[8 * j + k]
            arr, width = [
                None,
                (null_bits, 254), (coin_bits, 254), (rev_bits, 248),
                (bex_bits, 254), (pex_bits, 254),
            ][v]
            return _value_bit_lc(arr, 8 * (31 - j) + k, width)
        if byte == 192 and k == 0:
            return lc_const(1)
        if byte == 271 and k == 7:
            return lc_const(1)
        return lc_const(0)

    com_bits = keccak_static_cs(
        cs, "k_com", [com_msg_bit(b, k) for b in range(272) for k in range(8)], 2
    )
    com_bytes = digest_bits_to_byte_lcs(com_bits)
    commitment_lc = lc_add(
        *[lc_scale(com_bytes[j], pow(256, 30 - j, FR_MOD)) for j in range(31)]
    )
    constrain_linear_zero(cs, lc_sub(lc_wire(int(pub[0])), commitment_lc))

    # ---- last layer selection (:142-150) ----
    nl_oh = one_hot_cs(cs, "nl_oh", L, lc_sub(nlay, lc_const(1)))
    nl_filt = prefix_filter_cs(cs, "nl_filt", nl_oh)
    ll_part = cs.alloc_block("ll_part", (L, NB))
    for b in range(L):
        for j in range(NB):
            cs.add([(int(nl_oh[b]), 1)], lc_terms(layer_lcs[b][j]), [(int(ll_part[b, j]), 1)])
    last_layer = [
        lc_add(*[lc_wire(int(ll_part[b, j])) for b in range(L)]) for j in range(NB)
    ]
    lll_part = cs.alloc_block("lll_part", (L,))
    for b in range(L):
        cs.add([(int(nl_oh[b]), 1)], lc_terms(len_lcs[b]), [(int(lll_part[b]), 1)])
    last_len = lc_add(*[lc_wire(int(w)) for w in lll_part])
    exists = [
        lc_add(lc_wire(int(nl_filt[i])), lc_wire(int(nl_oh[i]))) for i in range(L)
    ]

    # ---- per-layer leaf detection, hashing, substring chain (:157-181) ----
    isleaf = []
    digests = []
    for i in range(L):
        isleaf.append(leaf_detector_cs(cs, f"ld{i}", layer_lcs[i], len_lcs[i]))
        digests.append(
            keccak_bytes_cs(cs, f"k_l{i}", layer_lcs[i], len_lcs[i], cfg.max_node_blocks)
        )
    constrain_linear_zero(cs, lc_sub(lc_add(*isleaf), lc_const(1)))  # (:186)
    for i in range(1, L):
        sub_bytes = digest_bits_to_byte_lcs(digests[i])[:31]
        out = substring_cs(cs, f"ss{i}", layer_lcs[i - 1], len_lcs[i - 1], sub_bytes)
        # (1 - substringChecker) * layerExists === 0 (:179)
        cs.add(lc_terms(lc_sub(lc_const(1), out)), lc_terms(exists[i]), [])

    d0 = digest_bits_to_byte_lcs(digests[0])
    for j in range(32):  # keccak(layers[0]) == stateRoot (:191-193)
        constrain_linear_zero(cs, lc_sub(d0[j], hdr_lcs[STATE_ROOT_OFFSET + j]))

    last_leaf_bit = leaf_detector_cs(cs, "ld_last", last_layer, last_len)  # (:187)
    constrain_linear_zero(cs, lc_sub(last_leaf_bit, lc_const(1)))

    # ---- recomputed leaf equals last layer (:195-206) ----
    leaf, leaf_len = mpt_leaf_cs(cs, "leaf", nib_lcs, nib_len, act, act_bits,
                                 cfg.amount_bytes)
    for i in range(MAX_LEAF_LEN):
        constrain_linear_zero(cs, lc_sub(leaf[i], last_layer[i]))
    constrain_linear_zero(cs, lc_sub(leaf_len, last_len))

    # ---- proof of work (:211, proof_of_work.circom:54-81) ----
    def pow_msg_bit(byte, k):
        if byte < 32:
            return _value_bit_lc(bk_bits, 8 * (31 - byte) + k, 254)
        if byte < 64:
            return _value_bit_lc(rev_bits, 8 * (31 - (byte - 32)) + k, 248)
        if byte < 96:
            return _value_bit_lc(bex_bits, 8 * (31 - (byte - 64)) + k, 254)
        if byte < 104:
            return lc_const((int(_POW_TAIL[byte - 96]) >> k) & 1)
        if byte == 104 and k == 0:
            return lc_const(1)
        if byte == 135 and k == 7:
            return lc_const(1)
        return lc_const(0)

    pow_bits = keccak_static_cs(
        cs, "k_pow", [pow_msg_bit(b, k) for b in range(136) for k in range(8)], 1
    )
    pow_bytes = digest_bits_to_byte_lcs(pow_bits)
    pw_oh = one_hot_cs(cs, "pw_oh", 33, lc_add(lc_const(cfg.pow_minimum_zero_bytes), relax))
    pw_filt = prefix_filter_cs(cs, "pw_filt", pw_oh)
    for i in range(32):
        cs.add(lc_terms(pow_bytes[i]), [(int(pw_filt[i]), 1)], [])
    return cs


# ---------------------------------------------------------------------------
# witness twin (tensors, batched)
# ---------------------------------------------------------------------------

_LT128_SHIFT = limb.int_to_limbs((1 << 248) - 128)


def _iz_wit(diff_limbs):
    """IsZero hints for canonical limb diffs: (inv limbs, out bits)."""
    out = limb.is_zero(diff_limbs).to(I32)
    inv = limb.from_mont(FR, limb.inv_mont(FR, limb.to_mont(FR, diff_limbs)))
    return inv, out




def _prefix_filter(oh):
    """f[i] = 1 iff i < index, matching prefix_filter_cs."""
    return 1 - oh.cumsum(-1, dtype=I32)


def _windows(a, n: int):
    """(..., m) -> (..., m + 1, n): row j = a[j:j+n], zero-filled past the
    end."""
    return tf.pad(a, (0, n)).unfold(-1, n, 1)


def _leaf_detector_wit(blocks, name, layer, layer_len):
    """Witness blocks for leaf_detector_cs. layer: (..., N) int32."""
    n = layer.shape[-1]
    d0 = wit.i32_sub_mod_p(layer[..., 0], 0xF8)
    d1 = wit.i32_sub_mod_p(layer[..., 1] + 2, layer_len)
    blocks[f"{name}_iza_inv"], blocks[f"{name}_iza_out"] = _iz_wit(torch.stack([d0, d1], -2))
    kp = layer[..., 2]
    blocks[f"{name}_ltb8"] = wit.int_bits(kp + 0x10000 - 0xB8, 17)
    blocks[f"{name}_lt81"] = wit.int_bits(kp + 0x10000 - 0x81, 17)
    leq_b7 = (kp <= 0xB7).to(I32)
    multi = ((kp >= 0x81) & (kp <= 0xB7)).to(I32)
    extra = multi * (kp - 0x80)
    blocks[f"{name}_multi"] = torch.stack([multi, extra], -1)
    key_len = 1 + extra
    oh = wit.one_hot(2 + key_len, n)
    blocks[f"{name}_oh"] = oh
    vals = []
    for k in range(4):
        part = oh * tf.pad(layer[..., k:], (0, k))
        blocks[f"{name}_p{k}"] = part
        vals.append(part.sum(-1, dtype=I32))
    vw, vw_len, vp, v_len = vals
    diffs = torch.stack([
        wit.i32_sub_mod_p(vw, 0xB8),
        wit.i32_sub_mod_p(vw_len, v_len + 2),
        wit.i32_sub_mod_p(vp, 0xF8),
        wit.i32_sub_mod_p(key_len + v_len + 6, layer_len),
    ], -2)
    inv, out = _iz_wit(diffs)
    blocks[f"{name}_izb_inv"], blocks[f"{name}_izb_out"] = inv, out
    bits = [(layer[..., 0] == 0xF8).to(I32), (layer[..., 1] + 2 == layer_len).to(I32), leq_b7,
            out[..., 0], out[..., 1], out[..., 2], out[..., 3]]
    chain, acc = [], bits[0]
    for bit in bits[1:]:
        acc = acc * bit
        chain.append(acc)
    blocks[f"{name}_and"] = torch.stack(chain, -1)
    return acc  # is_leaf (...,) int


@functools.lru_cache(maxsize=None)
def _pow256_mont(n: int):
    r = (1 << 256) % FR_MOD
    return limb.ints_to_limbs([pow(256, i, FR_MOD) * r % FR_MOD for i in range(n)])


def _field_cumsum(terms):
    """Running sums mod p of canonical terms (..., n, 16) along axis -2, as
    canonical limbs: one int64 cumulative sum of the limb columns, one carry
    fix, then x -> REDC(x) R^2 R^-1 = x mod p (two K1 launches on the card).
    The same values as a chain of n - 1 limb.add calls."""
    n = terms.shape[-2]
    cols = tf.pad(terms.to(torch.int64).cumsum(-2), (0, limb.L))  # each < n 2^16
    norm = limb.carry_fix(cols, limb.BITS + n.bit_length() + 1).to(I32)  # value < n p < p R
    red = limb.mont_reduce(FR, norm)
    return limb.mont_mul(FR, red, limb.const(_R2_FR_LIMBS, red))


_R2_FR_LIMBS = limb.int_to_limbs(pow(2, 512, FR_MOD))


def _substring_wit(blocks, name, main, main_len, sub_bytes):
    """Witness blocks for substring_cs. main: (..., N), sub_bytes: (..., 31)."""
    n = main.shape[-1]
    sub_len = sub_bytes.shape[-1]
    n_off = n - sub_len + 1
    blocks[f"{name}_geq"] = wit.int_bits(main_len - sub_len, 16)
    p256 = limb.const(_pow256_mont(n), main)
    # (..., N, 16) canonical 256^j main[j]
    terms = limb.mont_mul(FR, p256, limb.small_to_limbs(main))
    m_cum = _field_cumsum(terms)  # m_cum[j] = M[j+1]
    blocks[f"{name}_M"] = m_cum
    sub_terms = limb.mont_mul(FR, p256[:sub_len], limb.small_to_limbs(sub_bytes))
    sub_num = _field_cumsum(sub_terms)[..., -1, :]
    m_all = tf.pad(m_cum, (0, 0, 1, 0))  # M[k], k = 0 .. N
    lhs = limb.mont_mul(FR, p256[:n_off], sub_num[..., None, :])
    window = limb.sub(FR, m_all[..., sub_len:sub_len + n_off, :], m_all[..., :n_off, :])
    inv, ex = _iz_wit(limb.sub(FR, lhs, window))
    blocks[f"{name}_ex_inv"], blocks[f"{name}_ex_out"] = inv, ex
    oh = wit.one_hot(main_len - (sub_len - 1), n_off)
    blocks[f"{name}_oh"] = oh
    allowed = _prefix_filter(oh)
    blocks[f"{name}_alw"] = allowed
    sums = (allowed * ex).cumsum(-1, dtype=I32)
    blocks[f"{name}_sums"] = sums
    inv, dz = _iz_wit(limb.small_to_limbs(sums[..., -1])[..., None, :])
    blocks[f"{name}_dz_inv"], blocks[f"{name}_dz_out"] = inv, dz
    return 1 - dz[..., 0]  # found bit


def _mpt_leaf_wit(blocks, name, nibbles, nib_len, act_limbs):
    """Witness blocks for mpt_leaf_cs. nibbles: (..., 64) ints."""
    blocks[f"{name}_len7"] = wit.int_bits(nib_len, 7)
    blocks[f"{name}_lenmax"] = wit.int_bits(64 - nib_len, 7)
    ohc = wit.one_hot(64 - nib_len, 65)
    blocks[f"{name}_shoh"] = ohc
    shp = ohc[..., None] * _windows(nibbles, 64)  # shp[j, i] = ohc[j] nib[i + j]
    blocks[f"{name}_shp"] = shp
    shifted = shp.sum(-2, dtype=I32)  # (..., 64)
    rem, div = nib_len % 2, nib_len // 2
    blocks[f"{name}_rem"] = rem[..., None].to(I32)
    blocks[f"{name}_div"] = div[..., None].to(I32)
    blocks[f"{name}_div_bits"] = wit.int_bits(div, 6)
    blocks[f"{name}_on1"] = (rem * shifted[..., 0])[..., None]
    blocks[f"{name}_mid"] = torch.where(rem[..., None] == 1, shifted[..., 1:64],
                                        shifted[..., 0:63])
    blocks[f"{name}_onl"] = ((1 - rem) * shifted[..., 63])[..., None]
    key_len = 1 + div
    blocks[f"{name}_kl2"] = wit.int_bits(key_len - 2, 7)

    bal_bytes = limb.limbs_to_be_bytes(act_limbs)[..., 1:]  # (..., 31)
    blocks[f"{name}_bz_inv"], z = _iz_wit(limb.small_to_limbs(bal_bytes))
    blocks[f"{name}_bz_out"] = z
    sz = z.cumprod(-1).to(I32)
    blocks[f"{name}_sz"] = sz
    length = 31 - sz.sum(-1, dtype=I32)
    oh32 = wit.one_hot(31 - length, 32)
    blocks[f"{name}_rloh"] = oh32
    blocks[f"{name}_rlshp"] = oh32[..., None] * _windows(bal_bytes, 31)  # (..., 32, 31)
    # lt128: bits of (balance + 2^248 - 128), 249 bits
    blocks[f"{name}_lt128"] = limb.limbs_to_bits_le(
        limb.add(FR, act_limbs, limb.const(_LT128_SHIFT, act_limbs)), 249)
    inv, bz0 = _iz_wit(act_limbs[..., None, :])
    blocks[f"{name}_balz_inv"], blocks[f"{name}_balz_out"] = inv, bz0
    rlp_out, rlp_len, _ = rlp_integer(act_limbs, 31)  # (..., 32), (...,)
    blocks[f"{name}_first"] = (rlp_out[..., 0] - 0x80 * bz0[..., 0])[..., None]
    blocks[f"{name}_rest"] = rlp_out[..., 1:]

    blocks[f"{name}_accoh"] = wit.one_hot(3 + rlp_len, 36)
    account, account_len, _ = rlp_empty_account(act_limbs, 31)  # (..., 101)
    val = torch.cat([torch.full_like(account[..., :1], 0xB8), account_len[..., None], account],
                    -1)  # (..., 103)
    ohpk = wit.one_hot(3 + key_len, 37)
    blocks[f"{name}_pkoh"] = ohpk
    blocks[f"{name}_vp"] = ohpk[..., None] * val[..., None, :]


def _split_axis(blocks: dict, src: dict, axis: int, names) -> None:
    """blocks[names[i] + key] = v's slice i along `axis`, for each key, v of
    src (a gadget traced once over a stacked axis, given back per index)."""
    for k, v in src.items():
        for i, nm in enumerate(names):
            blocks[nm + k] = v.select(axis, i)


@traced("witness.trace")
def pob_r1cs_witness(cfg: PoBConfig, **kw):
    """Full witness blocks for a batch of PoB instances. kw: pob_forward's
    arguments as int32 tensors on one device (harness.inputs.to_device).
    Returns dict name -> tensor for assemble_witness(build_pob_cs(cfg), .)."""
    L, NB, HB = cfg.max_num_layers, cfg.max_node_bytes, cfg.max_header_bytes
    min_leaf = cfg.min_leaf_address_nibbles
    bk, act, inten = kw["burn_key"], kw["actual_balance"], kw["intended_balance"]
    rev, bex, pex = kw["reveal_amount"], kw["burn_extra_commitment"], kw["proof_extra_commitment"]
    nib_len, nlay = kw["num_leaf_address_nibbles"], kw["num_layers"]
    hlen, relax = kw["block_header_len"], kw["byte_security_relax"]
    layers, lens, hdr = kw["layers"], kw["layer_lens"], kw["block_header"]
    batch = bk.shape[:-1]
    nb = len(batch)
    dev = bk.device

    b = {}
    small = limb.small_to_limbs
    b["scalars"] = torch.stack(
        [bk, act, inten, rev, bex, small(nib_len), small(nlay), small(hlen), small(relax), pex],
        -2)
    b["layers"] = layers
    b["layer_lens"] = lens
    b["header"] = hdr

    fr_bits = limb.limbs_to_bits_le
    b["v_int"] = fr_bits(inten, 248)
    b["v_act"] = fr_bits(act, 248)
    b["v_rev"] = fr_bits(rev, 248)
    b["v_int_max"] = fr_bits(limb.sub(FR, const_limbs(cfg.max_intended_balance, batch, dev),
                                      inten), 248)
    b["v_act_max"] = fr_bits(limb.sub(FR, const_limbs(cfg.max_actual_balance, batch, dev),
                                      act), 248)
    b["v_int_act"] = fr_bits(limb.sub(FR, act, inten), 248)
    b["v_rev_int"] = fr_bits(limb.sub(FR, inten, rev), 248)
    b["v_relax2"] = wit.int_bits(2 * relax, 16)
    b["v_relax_min"] = wit.int_bits(min_leaf - 2 * relax, 16)
    b["v_nib"] = wit.int_bits(nib_len, 16)
    b["v_nib_min"] = wit.int_bits(nib_len - (min_leaf - 2 * relax), 16)
    for i in range(L):
        b[f"v_len{i}"] = wit.int_bits(lens[..., i], 16)
        b[f"v_lenmax{i}"] = wit.int_bits(NB * 8 - 1 - lens[..., i], 16)
    b["v_hlen"] = wit.int_bits(hlen, 16)
    b["v_hlenmax"] = wit.int_bits(HB * 8 - 1 - hlen, 16)
    b["layer_bits"] = wit.int_bits(layers, 8)
    b["header_bits"] = wit.int_bits(hdr, 8)

    # poseidons
    def pref(v):
        return const_limbs(v, batch, dev)

    pc, remaining = wit.poseidon_trace(
        torch.stack([pref(POSEIDON_COIN_PREFIX), bk, limb.sub(FR, inten, rev)], -2))
    pn, nullifier = wit.poseidon_trace(torch.stack([pref(POSEIDON_NULLIFIER_PREFIX), bk], -2))
    pa, addr_h = wit.poseidon_trace(
        torch.stack([pref(POSEIDON_BURN_ADDRESS_PREFIX), bk, rev, bex], -2))
    for nm, blk in (("p_coin", pc), ("p_null", pn), ("p_addr", pa)):
        for k in ("x2", "x4", "x5"):
            b[f"{nm}_{k}"] = blk[k]
    b["addr_bits"] = fr_bits(addr_h, 254)
    for k, v in wit.strict_bits_trace(b["addr_bits"]).items():
        b[f"addr_bits_{k}"] = v

    def padded_msg(parts, n_bytes, end):
        """The message bytes, 0x01 after them and 0x80 at byte `end`."""
        msg = torch.cat(parts + [torch.zeros(batch + (end + 1 - n_bytes,), dtype=I32,
                                             device=dev)], -1)
        msg[..., n_bytes] = 0x01
        msg[..., end] |= 0x80
        return msg

    # burn-address keccak (static, inLen=20)
    be_bytes = limb.limbs_to_be_bytes
    kb, ah_bits = wit.keccak_static_trace(padded_msg([be_bytes(addr_h)[..., :20]], 20, 135), 1)
    for k, v in kb.items():
        b[f"k_addr_{k}"] = v
    ah_bytes = wit.digest_bits_to_bytes(ah_bits)
    nibbles = torch.stack([ah_bytes >> 4, ah_bytes & 0xF], -1).flatten(-2)

    # header keccak (dynamic)
    kb, br_bits = wit.keccak_bytes_trace(hdr, hlen, cfg.max_header_blocks)
    for k, v in kb.items():
        b[f"k_hdr_{k}"] = v

    # commitment keccak (static, 2 blocks, 192 bytes)
    b["null_bits"] = fr_bits(nullifier, 254)
    b["coin_bits"] = fr_bits(remaining, 254)
    b["bex_bits"] = fr_bits(bex, 254)
    b["pex_bits"] = fr_bits(pex, 254)
    b["bk_bits"] = fr_bits(bk, 254)
    for nm in ("null_bits", "coin_bits", "bex_bits", "pex_bits", "bk_bits"):
        for k, v in wit.strict_bits_trace(b[nm]).items():
            b[f"{nm}_{k}"] = v
    com_msg = padded_msg([wit.digest_bits_to_bytes(br_bits)]
                         + [be_bytes(v) for v in (nullifier, remaining, rev, bex, pex)],
                         192, 271)
    kb, com_bits = wit.keccak_static_trace(com_msg, 2)
    for k, v in kb.items():
        b[f"k_com_{k}"] = v
    commitment = tf.pad(wit.digest_bits_to_bytes(com_bits)[..., :31], (1, 0))
    b["pub"] = limb.be_bytes_to_limbs(commitment)[..., None, :]

    # last-layer selection
    nl_oh = wit.one_hot(nlay - 1, L)
    b["nl_oh"] = nl_oh
    b["nl_filt"] = _prefix_filter(nl_oh)
    b["ll_part"] = nl_oh[..., None] * layers
    b["lll_part"] = nl_oh * lens
    last_layer = b["ll_part"].sum(-2, dtype=I32)
    last_len = b["lll_part"].sum(-1, dtype=I32)

    # every layer at once (the layer axis is one more batch axis): leaf
    # detector and keccak, then the substring checks of layers 1.. in 0..
    per_layer = {}
    _leaf_detector_wit(per_layer, "", layers, lens)
    _split_axis(b, per_layer, nb, [f"ld{i}" for i in range(L)])
    kb, dig = wit.keccak_bytes_trace(layers, lens, cfg.max_node_blocks)
    _split_axis(b, {f"_{k}": v for k, v in kb.items()}, nb, [f"k_l{i}" for i in range(L)])
    if L > 1:
        per_pair = {}
        _substring_wit(per_pair, "", layers[..., :-1, :], lens[..., :-1],
                       wit.digest_bits_to_bytes(dig[..., 1:, :])[..., :31])
        _split_axis(b, per_pair, nb, [f"ss{i}" for i in range(1, L)])
    _leaf_detector_wit(b, "ld_last", last_layer, last_len)

    _mpt_leaf_wit(b, "leaf", nibbles, nib_len, act)

    # proof of work keccak (static, inLen=104)
    tail = torch.from_numpy(_POW_TAIL).to(dev).expand(batch + (8,))
    pow_msg = padded_msg([be_bytes(bk), be_bytes(rev), be_bytes(bex), tail], 104, 135)
    kb, _ = wit.keccak_static_trace(pow_msg, 1)
    for k, v in kb.items():
        b[f"k_pow_{k}"] = v
    pw_oh = wit.one_hot(cfg.pow_minimum_zero_bytes + relax, 33)
    b["pw_oh"] = pw_oh
    b["pw_filt"] = _prefix_filter(pw_oh)
    return b
