"""msm_stage.ms_per_proof: prove_batch's own synchronized MSM stage time
(timings["msm_s"], the five MSMs and the copy of their sums to the host)
over the proofs of the window's untraced steps."""


def read(rec):
    steps = rec.get("steps")
    if not steps:
        return None
    return 1000 * sum(s["msm_s"] for s in steps) / sum(s["proofs"] for s in steps)
