"""The plain reference of Spend's public input (spend.circom:43-52):
keccak(coin || withdrawn || remaining coin || extra commitment) without its
last byte, coin = Poseidon3(coin prefix, burn key, balance) and remaining =
Poseidon3(coin prefix, burn key, balance - withdrawn)."""

from __future__ import annotations

from ..reference.keccak import keccak256
from ..reference.poseidon import POSEIDON_COIN_PREFIX, poseidon

R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def commitment(values) -> int:
    msg = b"".join(int(v).to_bytes(32, "big") for v in values)
    return int.from_bytes(keccak256(msg)[:31], "big")


def public_inputs(d: dict) -> list:
    key, bal, wd = int(d["burnKey"]), int(d["balance"]), int(d["withdrawnBalance"])
    coin = poseidon([POSEIDON_COIN_PREFIX, key, bal])
    remaining = poseidon([POSEIDON_COIN_PREFIX, key, (bal - wd) % R_MOD])
    return [commitment([coin, wd, remaining, int(d["extraCommitment"])])]
