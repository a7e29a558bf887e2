"""Shared arithmetic of the stage rooflines: least time from a stage's work
count and the peaks, per proof."""


def least_s(rec, stage: str):
    """(least seconds per proof, "operations" or "bytes"), or None."""
    w = rec.get("work", {}).get(stage)
    if not w:
        return None
    pk = rec["peaks"]
    ops = w["int32_muls"] / pk["int32_mul_per_s"]
    mem = w["bytes"] / pk["hbm_bytes_per_s"]
    return (ops, "operations") if ops >= mem else (mem, "bytes")


def share(rec, stage: str, key: str):
    steps = rec.get("steps")
    least = least_s(rec, stage)
    if not steps or least is None:
        return None
    spent = sum(s[key] for s in steps)
    if spent <= 0:
        return None
    proofs = sum(s["proofs"] for s in steps)
    return {"value": 100 * least[0] * proofs / spent, "bound_by": least[1]}
