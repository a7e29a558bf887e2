"""Protocol-specific building blocks of ProofOfBurn: burn-address
derivation, PoW check, public commitment (reference
circuits/utils/{burn_address,proof_of_work,public_commitment}.circom)."""

from __future__ import annotations

import numpy as np
import torch

from ..field import limb
from ..field.ref import FR_MOD
from ..gadgets.bytesops import I32, bytes_to_nibbles, filter_mask
from ..hash import keccak as kdev
from ..hash.poseidon import poseidon_limbs
from ..hash.poseidon_params import POSEIDON_BURN_ADDRESS_PREFIX

_POW_TAIL = np.frombuffer(b"EIP-7503", np.uint8).astype(np.int32)


def const_limbs(v: int, batch_shape, device):
    """A python-int Fr constant as a limb scalar, broadcast over batch axes."""
    arr = torch.from_numpy(limb.int_to_limbs(v % FR_MOD)).to(device)
    return arr.expand(tuple(batch_shape) + (limb.L,))


def poseidon_fixed(values):
    """Poseidon over a list of (..., 16) canonical limb scalars."""
    return poseidon_limbs(torch.stack(torch.broadcast_tensors(*values), -2))


def public_commitment(values_be32):
    """PublicCommitment(N) (public_commitment.circom:18-42):
    keccak(concat of N 32-byte values) >> 8, as an Fr limb scalar.
    values_be32: (..., N, 32) int32 bytes. Returns (commitment_limbs, ok)."""
    flat = values_be32.flatten(-2)
    ok = ((flat >= 0) & (flat < 256)).all(-1)
    digest = kdev.keccak_fixed(flat)  # (..., 32)
    # drop the least-significant byte
    padded = torch.nn.functional.pad(digest[..., :31], (1, 0))
    return limb.be_bytes_to_limbs(padded), ok


def _keccak_block(msg, in_len: int):
    """Keccak256 of one block's worth of bytes msg (..., in_len < 136)."""
    block = torch.nn.functional.pad(msg, (0, kdev.RATE - in_len))
    return kdev.keccak_bytes(block, torch.full(msg.shape[:-1], in_len, dtype=I32,
                                               device=msg.device), 1)


def burn_address_hash(burn_key, reveal_amount, burn_extra):
    """BurnAddressHash (burn_address.circom:67-83): keccak(first 20 BE bytes of
    Poseidon4(prefix, burnKey, revealAmount, burnExtraCommitment)) as 64
    nibbles. Inputs are canonical limb scalars."""
    batch = burn_key.shape[:-1]
    h = poseidon_fixed([const_limbs(POSEIDON_BURN_ADDRESS_PREFIX, batch, burn_key.device),
                        burn_key, reveal_amount, burn_extra])
    return bytes_to_nibbles(_keccak_block(limb.limbs_to_be_bytes(h)[..., :20], 20))


def pow_check(burn_key, reveal_amount, burn_extra, min_zero_bytes):
    """ProofOfWorkChecker (proof_of_work.circom:54-81): the first
    min_zero_bytes bytes of keccak(BE32(burnKey)||BE32(reveal)||BE32(extra)||
    'EIP-7503') must be zero. Returns a bool flag."""
    batch = burn_key.shape[:-1]
    tail = torch.from_numpy(_POW_TAIL).to(burn_key.device).expand(batch + (8,))
    msg = torch.cat([limb.limbs_to_be_bytes(v) for v in (burn_key, reveal_amount, burn_extra)]
                    + [tail], -1)  # (..., 104)
    digest = _keccak_block(msg, 104)
    return (digest * filter_mask(min_zero_bytes, 32) == 0).all(-1)
