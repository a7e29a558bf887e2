"""The plain reference of ProofOfBurn's public input
(proof_of_burn.circom:113-139): keccak of the block root, the nullifier,
the remaining coin, the revealed amount, the burn's and the proof's extra
commitments, without its last byte."""

from __future__ import annotations

from ..reference.keccak import keccak256
from ..reference.poseidon import POSEIDON_COIN_PREFIX, POSEIDON_NULLIFIER_PREFIX, poseidon
from .spend_ref import R_MOD, commitment


def public_inputs(d: dict) -> list:
    header = bytes(int(b) for b in d["blockHeader"][:int(d["blockHeaderLen"])])
    key = int(d["burnKey"])
    remaining = poseidon([POSEIDON_COIN_PREFIX, key,
                          (int(d["intendedBalance"]) - int(d["revealAmount"])) % R_MOD])
    return [commitment([
        int.from_bytes(keccak256(header), "big"),
        poseidon([POSEIDON_NULLIFIER_PREFIX, key]),
        remaining,
        int(d["revealAmount"]),
        int(d["burnExtraCommitment"]),
        int(d.get("_proofExtraCommitment", 0)),
    ])]
