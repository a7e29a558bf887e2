"""Witness-side twins of the constraint gadgets: tensor trace functions that
recompute each permutation while exporting every intermediate wire block in
the exact order the constraint builders (gadgets_cs.py) allocate them.
Batched: one proof instance per leading batch lane."""

from __future__ import annotations

import torch

from ..field import limb
from ..field.limb import FR
from ..hash import keccak as kdev
from ..hash import poseidon
from ..hash.keccak import _CHI1, _CHI2, _RC_HI, _RC_LO, _ROT, _SRC, _idx, _not32, _rotl64
from ..utils.metrics import traced

I32 = torch.int32


def lane_bits(lo, hi):
    """(..., L) 32-bit lane halves -> (..., L, 64) int32 bits, LSB first."""
    shifts = torch.arange(32, device=lo.device)
    b_lo = (lo[..., None] >> shifts) & 1
    b_hi = (hi[..., None] >> shifts) & 1
    return torch.cat([b_lo, b_hi], -1).to(I32)


def keccak_f_trace(lo, hi):
    """Run keccak-f while exporting the constraint wire blocks.

    Returns (blocks, (lo_out, hi_out)) where blocks is a dict:
      tc (..., 24, 4, 5, 64), d (..., 24, 5, 64), to/ca/co (..., 24, 25, 64)
    — bit tensors matching gadgets_cs.keccak_f_cs allocation order."""
    src, c1, c2 = _idx(_SRC, lo), _idx(_CHI1, lo), _idx(_CHI2, lo)
    tcs, ds, tos, cas, cos = [], [], [], [], []
    for r in range(24):
        # theta xor chains: tc[step][x] = s[x] ^ s[x+5] ^ ... ^ s[x+5(step+1)]
        steps_lo, steps_hi = [lo[..., 0:5]], [hi[..., 0:5]]
        for k in range(4):
            steps_lo.append(steps_lo[-1] ^ lo[..., 5 * (k + 1):5 * (k + 2)])
            steps_hi.append(steps_hi[-1] ^ hi[..., 5 * (k + 1):5 * (k + 2)])
        tc_lo, tc_hi = torch.stack(steps_lo[1:], -2), torch.stack(steps_hi[1:], -2)
        c_lo, c_hi = steps_lo[-1], steps_hi[-1]
        rot_lo, rot_hi = _rotl64(c_lo.roll(-1, -1), c_hi.roll(-1, -1), 1)
        d_lo = c_lo.roll(1, -1) ^ rot_lo
        d_hi = c_hi.roll(1, -1) ^ rot_hi
        t_lo = lo ^ d_lo.tile(5)
        t_hi = hi ^ d_hi.tile(5)
        b_lo, b_hi = _rotl64(t_lo[..., src], t_hi[..., src], _ROT)
        a_lo = _not32(b_lo[..., c1]) & b_lo[..., c2]
        a_hi = _not32(b_hi[..., c1]) & b_hi[..., c2]
        o_lo, o_hi = b_lo ^ a_lo, b_hi ^ a_hi
        tcs.append(lane_bits(tc_lo, tc_hi))
        ds.append(lane_bits(d_lo, d_hi))
        tos.append(lane_bits(t_lo, t_hi))
        cas.append(lane_bits(a_lo, a_hi))
        cos.append(lane_bits(o_lo, o_hi))
        lo = torch.cat([o_lo[..., :1] ^ int(_RC_LO[r]), o_lo[..., 1:]], -1)
        hi = torch.cat([o_hi[..., :1] ^ int(_RC_HI[r]), o_hi[..., 1:]], -1)
    blocks = {
        "tc": torch.stack(tcs, -4),
        "d": torch.stack(ds, -3),
        "to": torch.stack(tos, -3),
        "ca": torch.stack(cas, -3),
        "co": torch.stack(cos, -3),
    }
    return blocks, (lo, hi)


@traced("witness.poseidon")
def poseidon_trace(input_limbs):
    """Poseidon over (..., n, 16) canonical limb inputs, exporting the s-box
    intermediates. Returns (blocks, out_limbs) with blocks x2/x4/x5 of shape
    (..., total_sbox, 16) canonical limbs, matching gadgets_cs.poseidon_cs
    (round-major, lane-minor)."""
    t = input_limbs.shape[-2] + 1
    consts = poseidon._round_consts(t)
    state = limb.to_mont(FR, input_limbs)
    state = torch.cat([torch.zeros_like(state[..., :1, :]), state], -2)
    trace = {"x2": [], "x4": [], "x5": []}
    for r, full in poseidon.round_schedule(t):
        state = limb.add(FR, state, limb.const(consts[r], state))
        lanes = state if full else state[..., 0:1, :]
        x2, x4, x5 = poseidon.sigma(lanes)
        for name, v in (("x2", x2), ("x4", x4), ("x5", x5)):
            trace[name].append(v)
        state = x5 if full else torch.cat([x5, state[..., 1:, :]], -2)
        state = poseidon.mix(state, t)
    blocks = {k: limb.from_mont(FR, torch.cat(v, -2)) for k, v in trace.items()}
    return blocks, limb.from_mont(FR, state[..., 0, :])


def strict_bits_trace(bits):
    """Witness twin of gadgets_cs.strict_bits_cs: the suffix-equality chain
    eq[i] = prod_{j>=i} (b_j == k_j) against k = bits(p-1), and the gt terms
    eq[i+1]*b_i at the zero positions of p-1. bits: (..., 254) int32.
    Returns {"eq": (..., 254), "gt": (..., n_zero)} int32 tensors."""
    from .gadgets_cs import P_MINUS_1_BITS, STRICT_ZERO_POS

    k = torch.as_tensor(P_MINUS_1_BITS, device=bits.device)
    t = torch.where(k == 1, bits, 1 - bits)
    eq = t.flip(-1).cumprod(-1).flip(-1)
    eq_next = torch.cat([eq[..., 1:], torch.ones_like(eq[..., :1])], -1)
    zp = torch.as_tensor(STRICT_ZERO_POS, device=bits.device)
    gt = eq_next[..., zp] * bits[..., zp]
    return {"eq": eq.to(I32), "gt": gt.to(I32)}


def bits_to_limb_block(bits):
    """(..., n) 0/1 int32 -> (..., n, 16) limb values."""
    out = torch.zeros(bits.shape + (limb.L,), dtype=I32, device=bits.device)
    out[..., 0] = bits
    return out


def one_hot(idx, n: int):
    """(...,) int tensor -> (..., n) int32 one-hot; all zero where idx is
    out of range (as jax.nn.one_hot)."""
    return (torch.arange(n, device=idx.device) == idx[..., None]).to(I32)


def int_bits(v, n: int):
    """(...,) non-negative int tensor -> (..., n) LSB-first int32 bits."""
    shifts = torch.arange(n, device=v.device)
    return ((v.to(torch.int64)[..., None] >> shifts) & 1).to(I32)


def _dynamic_absorb_trace(padded, n_blocks: int):
    """keccak_f_trace over each absorption of an already padded message:
    (blocks, digest bits after each block (..., n_blocks, 256)). Block keys:
    'b{b}_ax' (the absorbed state's rate lanes, b > 0) and 'b{b}_tc' etc."""
    blk_lo, blk_hi = kdev.bytes_to_blocks(padded, n_blocks)
    lo = torch.zeros(padded.shape[:-1] + (25,), dtype=torch.int64, device=padded.device)
    hi = torch.zeros_like(lo)
    blocks, digests = {}, []
    for b in range(n_blocks):
        ax_lo = lo[..., :17] ^ blk_lo[..., b, :]
        ax_hi = hi[..., :17] ^ blk_hi[..., b, :]
        if b > 0:
            blocks[f"b{b}_ax"] = lane_bits(ax_lo, ax_hi)
        lo = torch.cat([ax_lo, lo[..., 17:]], -1)
        hi = torch.cat([ax_hi, hi[..., 17:]], -1)
        kb, (lo, hi) = keccak_f_trace(lo, hi)
        for k, v in kb.items():
            blocks[f"b{b}_{k}"] = v
        digests.append(lane_bits(lo[..., :4], hi[..., :4]).flatten(-2))
    return blocks, torch.stack(digests, -2)


@traced("witness.keccak")
def keccak_static_trace(msg_bytes, n_blocks: int):
    """Witness twin of a static-length keccak chain: msg_bytes
    (..., n_blocks*136) already padded. Returns (blocks, digest_bits) where
    blocks holds, per block b, 'b{b}_ax' (b > 0) and the keccak_f_trace
    blocks 'b{b}_tc' etc.; digest_bits is (..., 256) of the final state."""
    blocks, digests = _dynamic_absorb_trace(msg_bytes, n_blocks)
    return blocks, digests[..., -1, :]


@traced("witness.keccak")
def keccak_bytes_trace(data, in_len, max_blocks: int):
    """Witness twin of gadgets_cs.keccak_bytes_cs. data: (..., max_bytes)
    int32 bytes; in_len: (...,) int tensor. Returns (blocks, digest_bits)
    with block keys in the cs allocation order (sans name prefix)."""
    max_bytes = max_blocks * kdev.RATE
    in_len = in_len.to(torch.int64)
    div = in_len // kdev.RATE
    rem = in_len % kdev.RATE
    blocks = {
        "div": div[..., None].to(I32),
        "rem_bits": int_bits(rem, 8),
        "rem_hi_bits": int_bits(135 - rem, 8),
        "len_oh": one_hot(in_len, max_bytes),
        "blk_oh": one_hot(div, max_blocks),
    }
    idx = torch.arange(max_bytes, device=data.device)
    blocks["filter"] = (idx < in_len[..., None]).to(I32)
    padded, _ = kdev.pad_bytes(data, in_len, max_blocks)
    blocks["padded"] = padded
    blocks["pbits"] = int_bits(padded, 8)
    kblocks, digest_per_block = _dynamic_absorb_trace(padded, max_blocks)
    blocks.update(kblocks)
    # digest select partials: sel[b, bit] = blk_oh[b] * digest_b[bit]
    sel = blocks["blk_oh"][..., :, None] * digest_per_block  # (..., max_blocks, 256)
    blocks["sel"] = sel
    return blocks, sel.sum(-2, dtype=I32)


def digest_bits_to_bytes(digest_bits):
    """(..., 256) bits -> (..., 32) bytes."""
    pairs = digest_bits.reshape(digest_bits.shape[:-1] + (32, 8)).to(torch.int64)
    return (pairs << torch.arange(8, device=pairs.device)).sum(-1).to(I32)


# ---------------------------------------------------------------------------
# small-field helpers for hint wires
# ---------------------------------------------------------------------------


def i32_sub_mod_p(a, b):
    """(a - b) mod p as limb scalars, for small non-negative int tensors a, b
    (either may be a python int)."""
    d = torch.as_tensor(a).to(torch.int64) - torch.as_tensor(b).to(torch.int64)
    return limb.sub(FR, limb.small_to_limbs(d.clamp(min=0)),
                    limb.small_to_limbs((-d).clamp(min=0)))


def is_zero_hints(diff_limbs):
    """diff values (n, ..., 16) canonical -> (out bits, inv limbs) matching
    gadgets_cs.is_zero_cs (the caller orders {name}_inv then {name}_out)."""
    zero = limb.is_zero(diff_limbs)
    inv = limb.from_mont(FR, limb.batch_inv_mont(FR, limb.to_mont(FR, diff_limbs), axis=0))
    return zero.to(I32), inv
