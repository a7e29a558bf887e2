"""The toy circuit's public input from its input: x^3 + x + 5."""

R_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617


def public_inputs(d: dict) -> list:
    x = int(d["x"])
    return [(x ** 3 + x + 5) % R_MOD]
