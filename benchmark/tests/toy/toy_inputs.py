"""Seeded inputs of the toy circuit: a pool of x values, fresh x per proof."""

from __future__ import annotations

R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def pool(cfg: dict, rng, size: int) -> list:
    return [{"x": rng.randrange(R_MOD)} for _ in range(size)]


def fresh(item: dict, rng) -> dict:
    return {"x": (item["x"] + rng.randrange(R_MOD)) % R_MOD}
