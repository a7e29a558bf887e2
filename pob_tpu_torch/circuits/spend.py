"""Spend circuit (reference circuits/spend.circom:32-53): partially withdraw
an encrypted coin. Batched forward on tensors, one instance per leading
batch lane; the port's copy of pob_tpu's circuits/spend.py."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..field import limb
from ..field.limb import FR
from ..gadgets.bytesops import limb_fits_bits, limb_leq, limbs_to_be_bytes_checked
from ..hash.poseidon_params import POSEIDON_COIN_PREFIX
from .common import const_limbs, poseidon_fixed, public_commitment


@dataclass(frozen=True)
class SpendConfig:
    max_amount_bytes: int = 31  # prod instantiation (main_spend.circom:5)

    def __post_init__(self):
        if self.max_amount_bytes > 31:
            raise ValueError("max_amount_bytes must be at most 31")


def spend_forward(cfg: SpendConfig, burn_key, balance, withdrawn, extra_commitment):
    """All inputs are canonical Fr limb scalars (..., 16) on one device.

    Returns a dict with `commitment`, `coin`, `remaining_coin` (limb
    scalars) and `valid` (bool): the AND of every circom-side assertion."""
    bits = cfg.max_amount_bytes * 8
    batch = burn_key.shape[:-1]

    # AssertGreaterEqThan(maxAmountBytes*8)(balance, withdrawnBalance) (:41)
    ok = limb_fits_bits(balance, bits) & limb_fits_bits(withdrawn, bits) & limb_leq(withdrawn,
                                                                                     balance)
    prefix = const_limbs(POSEIDON_COIN_PREFIX, batch, burn_key.device)
    coin = poseidon_fixed([prefix, burn_key, balance])  # (:43)
    remaining = poseidon_fixed([prefix, burn_key, limb.sub(FR, balance, withdrawn)])  # (:44)

    vals = []
    for v in (coin, withdrawn, remaining, extra_commitment):
        b, ok_b = limbs_to_be_bytes_checked(v, 32)
        ok = ok & ok_b
        vals.append(b)
    commitment, ok_c = public_commitment(torch.stack(vals, -2))  # (:46-52)
    return {"commitment": commitment, "coin": coin, "remaining_coin": remaining,
            "valid": ok & ok_c}
