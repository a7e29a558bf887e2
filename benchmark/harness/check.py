"""The comparison that decides `correct`: the proofs of the steps the run
kept (a seeded uniform sample of the window's steps), judged against the
plain reference after the window, with the numbers compared and their limits.

For each kept proof the reference works out, from the seed's toxic waste and
blinding and the witness the window produced, the exact proof it must be
(reference/groth16.py), and from the inputs alone its public input
(configs/<name>_ref.py). The reference reads the program's constraint
system, so the run also holds its SHA-256 against the configuration's
(harness/r1cs.py; r1cs_changed, set by the run). Every limit is exact: 0
wrong proofs, 0 wrong public inputs, at least one proof compared, and the
constraint system unchanged."""

from __future__ import annotations

import torch

LIMITS = {"proofs_wrong": ("max", 0), "public_wrong": ("max", 0), "proofs_checked": ("min", 1),
          "r1cs_changed": ("max", 0)}


def judge(kept, shadow, public_inputs, num_public: int, device, control: bool = False) -> dict:
    """kept: [(inputs, rs, W (B, nw, 16) int tensor on the host, proofs)].
    control: judge the reference's own proofs made without the blinding in
    place of the program's (the check's control, which has to fail)."""
    checked = wrong = public_wrong = 0
    for items, rs, W, proofs in kept:
        W = W.to(torch.int64)
        in_range = ((W >= 0) & (W <= 0xFFFF)).flatten(1).all(1).tolist()
        dots = shadow.scalars(W.to(device))
        pubs = [_ints(W[b, 1:1 + num_public]) for b in range(W.shape[0])]
        for b, (item, (r, s)) in enumerate(zip(items, rs)):
            checked += 1
            public_wrong += pubs[b] != public_inputs(item)
            got = proofs[b] if b < len(proofs) else None
            if control:
                got = shadow.expected(dots[b], r, s, blind=False)
            ok = in_range[b] and got is not None and tuple(got) == shadow.expected(dots[b], r, s)
            wrong += not ok
    return {"proofs_wrong": wrong, "public_wrong": public_wrong, "proofs_checked": checked}


def passed(numbers: dict) -> bool:
    for name, (kind, limit) in LIMITS.items():
        v = numbers[name]
        if (kind == "max" and v > limit) or (kind == "min" and v < limit):
            return False
    return True


def lines(numbers: dict) -> dict:
    """{name: {"value", "limit"}} in LIMITS's order, for the result line."""
    return {name: {"value": numbers[name], "limit": limit, "kind": kind}
            for name, (kind, limit) in LIMITS.items()}


def _ints(limbs) -> list:
    return [sum(int(v) << (16 * k) for k, v in enumerate(row)) for row in limbs.tolist()]
