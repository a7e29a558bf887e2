"""Seeded spends for Spend(31): a coin's burn key and balance, the amount
withdrawn and the extra commitment, in the reference's input format
(tests/main.py:182-192), within Spend(31)'s ranges (balance and withdrawn
below 2^248, withdrawn at most the balance). The amounts' range is the
configuration file's "assumed" entry."""

from __future__ import annotations

import random

R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def pool(cfg: dict, rng: random.Random, size: int) -> list:
    """`size` coins: a burn key and a balance each."""
    lo, hi = cfg["assumed"]["balance_wei"]
    return [{"burnKey": str(rng.randrange(R_MOD)), "balance": str(rng.randint(lo, hi))}
            for _ in range(size)]


def fresh(item: dict, rng: random.Random) -> dict:
    """A spend of the coin: a fresh withdrawn amount and extra commitment, so
    that no two proofs share a witness."""
    return dict(item, withdrawnBalance=str(rng.randint(0, int(item["balance"]))),
                extraCommitment=rng.randrange(R_MOD))
