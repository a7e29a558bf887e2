"""prove.launches_per_proof: the kernel launches inside prove_batch (its
timings["launches"], the launch counters of the port's kernels), over the
proofs of the window's untraced steps."""


def read(rec):
    steps = rec.get("steps")
    if not steps or "launches" not in steps[0]:
        return None
    return sum(sum(s["launches"].values()) for s in steps) / sum(s["proofs"] for s in steps)
