"""Spend circuit as an R1CS: constraint builder + tensor witness generator.

The statement matches circuits/spend.circom:32-53 exactly (same public
commitment, same range assertions); linear layers stay symbolic, Poseidon /
Keccak allocate only s-box / bit-op wires.

Block contract: build_spend_cs() allocates witness blocks in the same order
spend_witness() produces them; ConstraintSystem.check_witness verifies the
pairing in tests. The witness runs on the device of its input tensors (the
field operations through K1 on a CUDA tensor)."""

from __future__ import annotations

import functools

import torch

from ..field import limb
from ..field.limb import FR
from ..field.ref import FR_MOD
from ..hash import keccak as kdev
from ..hash.poseidon_params import POSEIDON_COIN_PREFIX
from ..utils.metrics import METRICS, traced
from .builder import ConstraintSystem
from .gadgets_cs import (
    constrain_decomposition,
    constrain_linear_zero,
    keccak_f_cs,
    poseidon_cs,
    strict_bits_cs,
)
from .lc import lc_const, lc_scale, lc_sub, lc_wire
from . import witness as wit

I32 = torch.int32
_PREFIX = limb.int_to_limbs(POSEIDON_COIN_PREFIX)

_N_BITS = 254  # value decomposition width (field elements)


def _value_bit(bits_arr, k: int):
    return lc_wire(bits_arr[k]) if k < _N_BITS else lc_const(0)


@functools.lru_cache(maxsize=None)
def build_spend_cs() -> ConstraintSystem:
    cs = ConstraintSystem()
    pub = cs.alloc_block("pub", (1,))
    cs.mark_public(1)
    inp = cs.alloc_block("inputs", (4,))  # burnKey, balance, withdrawn, extra
    bk, bal, wd, ex = (lc_wire(int(w)) for w in inp)

    bal_bits = cs.alloc_block("balance_bits", (248,), width=1)
    wd_bits = cs.alloc_block("withdrawn_bits", (_N_BITS,), width=1)
    diff_bits = cs.alloc_block("diff_bits", (248,), width=1)
    # AssertGreaterEqThan(248)(balance, withdrawn) (spend.circom:41):
    # balance < 2^248, withdrawn < 2^248, balance - withdrawn in [0, 2^248)
    constrain_decomposition(cs, bal, bal_bits)
    constrain_decomposition(cs, wd, wd_bits)
    for i in range(248, _N_BITS):
        constrain_linear_zero(cs, lc_wire(int(wd_bits[i])))
    constrain_decomposition(cs, lc_sub(bal, wd), diff_bits)

    prefix = lc_const(POSEIDON_COIN_PREFIX)
    coin = poseidon_cs(cs, "pc", [prefix, bk, bal])  # (:43)
    remaining = poseidon_cs(cs, "pr", [prefix, bk, lc_sub(bal, wd)])  # (:44)

    coin_bits = cs.alloc_block("coin_bits", (_N_BITS,), width=1)
    rem_bits = cs.alloc_block("remaining_bits", (_N_BITS,), width=1)
    ex_bits = cs.alloc_block("extra_bits", (_N_BITS,), width=1)
    # full-width decompositions need the Num2Bits_strict alias check
    # (convert.circom:46-56): without it the x + p encoding binds a different
    # keccak message (hence a different commitment) to the same field values.
    constrain_decomposition(cs, coin, coin_bits)
    strict_bits_cs(cs, "coin_bits", coin_bits)
    constrain_decomposition(cs, remaining, rem_bits)
    strict_bits_cs(cs, "remaining_bits", rem_bits)
    constrain_decomposition(cs, ex, ex_bits)
    strict_bits_cs(cs, "extra_bits", ex_bits)

    # PublicCommitment(4): keccak over 128 message bytes + static padding
    # (public_commitment.circom:18-42; padding per keccak.circom:412-446 with
    # inLen fixed at 128).
    values = [coin_bits, wd_bits, rem_bits, ex_bits]

    def msg_bit(b: int, k: int):
        if b < 128:
            v, j = divmod(b, 32)  # value index, big-endian byte index
            return _value_bit(values[v], 8 * (31 - j) + k)
        if b == 128:
            return lc_const(1 if k == 0 else 0)
        if b == 135:
            return lc_const(1 if k == 7 else 0)
        return lc_const(0)

    state_lcs = [
        [
            msg_bit(l * 8 + z // 8, z % 8) if l < 17 else lc_const(0)
            for z in range(64)
        ]
        for l in range(25)
    ]
    out_lcs = keccak_f_cs(cs, "k", state_lcs).to_lcs()

    # commitment = BE pack of digest bytes 0..30 (drop last byte)
    commit_lc = lc_const(0)
    for j in range(31):
        byte_lc = lc_const(0)
        for k in range(8):
            byte_lc = lc_sub(byte_lc, lc_scale(out_lcs[j // 8][(j % 8) * 8 + k], FR_MOD - (1 << k)))
        commit_lc = lc_sub(commit_lc, lc_scale(byte_lc, FR_MOD - pow(256, 30 - j, FR_MOD)))
    constrain_linear_zero(cs, lc_sub(lc_wire(int(pub[0])), commit_lc))
    return cs


@traced("witness.trace")
def spend_witness(burn_key, balance, withdrawn, extra):
    """Witness blocks for a batch of spend instances.

    Inputs: (batch, 16) int32 canonical limb scalars. Returns dict name ->
    tensor (limb blocks as (..., n, 16) int32, bit blocks as int32)."""
    batch = burn_key.shape[:-1]
    dev = burn_key.device
    bits = limb.limbs_to_bits_le
    diff = limb.sub(FR, balance, withdrawn)

    prefix = limb.const(_PREFIX, burn_key).expand(batch + (limb.L,))
    pc_blocks, coin = wit.poseidon_trace(torch.stack([prefix, burn_key, balance], -2))
    pr_blocks, remaining = wit.poseidon_trace(torch.stack([prefix, burn_key, diff], -2))

    # keccak message: 4 BE 32-byte values + 0x01 ... 0x80 padding
    with METRICS.span("witness.keccak"):
        msg = torch.cat(
            [limb.limbs_to_be_bytes(v) for v in (coin, withdrawn, remaining, extra)]
            + [torch.zeros(batch + (8,), dtype=I32, device=dev)], -1)
        msg[..., 128] = 0x01
        msg[..., 135] = 0x80
        blk_lo, blk_hi = kdev.bytes_to_blocks(msg, 1)  # (..., 1, 17)
        pad = torch.zeros(batch + (8,), dtype=torch.int64, device=dev)
        lo = torch.cat([blk_lo[..., 0, :], pad], -1)
        hi = torch.cat([blk_hi[..., 0, :], pad], -1)
        kblocks, (flo, fhi) = wit.keccak_f_trace(lo, hi)
        digest = kdev.state_to_digest(flo, fhi)
    commitment = torch.zeros(batch + (32,), dtype=I32, device=dev)
    commitment[..., 1:] = digest[..., :31]
    commitment = limb.be_bytes_to_limbs(commitment)

    out = {
        "pub": commitment[..., None, :],
        "inputs": torch.stack([burn_key, balance, withdrawn, extra], -2),
        "balance_bits": bits(balance, 248),
        "withdrawn_bits": bits(withdrawn, _N_BITS),
        "diff_bits": bits(diff, 248),
        "pc_x2": pc_blocks["x2"],
        "pc_x4": pc_blocks["x4"],
        "pc_x5": pc_blocks["x5"],
        "pr_x2": pr_blocks["x2"],
        "pr_x4": pr_blocks["x4"],
        "pr_x5": pr_blocks["x5"],
        "coin_bits": bits(coin, _N_BITS),
        "remaining_bits": bits(remaining, _N_BITS),
        "extra_bits": bits(extra, _N_BITS),
    }
    for nm, val in (("coin_bits", coin), ("remaining_bits", remaining), ("extra_bits", extra)):
        for k, v in wit.strict_bits_trace(bits(val, _N_BITS)).items():
            out[f"{nm}_{k}"] = v
    for k in ("tc", "d", "to", "ca", "co"):
        out[f"k_{k}"] = kblocks[k]
    return out


@traced("witness.assemble")
def assemble_witness(cs: ConstraintSystem, tensors: dict):
    """Blocks dict -> (batch, num_wires, 16) int32 witness buffer (wire 0 = 1)."""
    pub = tensors["pub"]
    batch = pub.shape[:-2]
    buf = torch.zeros(batch + (cs.num_wires, limb.L), dtype=I32, device=pub.device)
    buf[..., 0, 0] = 1
    for blk in cs.blocks:
        t = tensors[blk.name]
        n = 1
        for s in blk.shape:
            n *= s
        if tuple(t.shape[len(batch):]) == tuple(blk.shape):  # bit/int block
            t = wit.bits_to_limb_block(t.to(I32))
        buf[..., blk.start:blk.start + n, :] = t.reshape(batch + (n, limb.L))
    return buf


def spend_full_witness(burn_key, balance, withdrawn, extra):
    """(batch, num_wires, 16) Spend witness of build_spend_cs from the four
    inputs' canonical limb scalars (batch, 16)."""
    return assemble_witness(build_spend_cs(), spend_witness(burn_key, balance, withdrawn, extra))
