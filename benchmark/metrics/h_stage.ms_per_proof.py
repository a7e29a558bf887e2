"""h_stage.ms_per_proof: prove_batch's own synchronized h stage time
(timings["h_s"]) over the proofs of the window's untraced steps."""


def read(rec):
    steps = rec.get("steps")
    if not steps:
        return None
    return 1000 * sum(s["h_s"] for s in steps) / sum(s["proofs"] for s in steps)
