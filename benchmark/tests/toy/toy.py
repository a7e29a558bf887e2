"""A four-constraint circuit built with the program's constraint builder and
proved by the program's Groth16 on the CPU: the stand-in configuration of
the harness's CPU tests. The witness is worked out on the host."""

from __future__ import annotations

import torch

from pob_tpu_torch.field import limb
from pob_tpu_torch.r1cs.builder import ConstraintSystem

R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def build(k: int = 3) -> ConstraintSystem:
    """k: the last constraint's coefficient of x, on both of its sides."""
    cs = ConstraintSystem()
    pub = cs.alloc_block("pub", (1,))
    cs.mark_public(1)
    x, x2, x3 = (int(w) for w in cs.alloc_block("x", (3,)))
    cs.add([(x, 1)], [(x, 1)], [(x2, 1)])
    cs.add([(x2, 1)], [(x, 1)], [(x3, 1)])
    cs.add([(x3, 1), (x, 1), (0, 5)], [(0, 1)], [(int(pub[0]), 1)])
    cs.add([(x, k), (x2, R_MOD - 1)], [(0, 1)], [(x, k), (x2, R_MOD - 1)])
    return cs


class Circuit:
    def __init__(self, cfg: dict):
        self.cs = build()

    def witness(self, items: list, device):
        rows = []
        for d in items:
            x = int(d["x"])
            rows += [1, (x ** 3 + x + 5) % R_MOD, x, x * x % R_MOD, x ** 3 % R_MOD]
        return torch.from_numpy(limb.ints_to_limbs(rows).reshape(len(items), 5, 16)).to(device)
