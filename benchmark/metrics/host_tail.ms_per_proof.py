"""host_tail.ms_per_proof: the benchmark's span around prove_batch less its
h stage and MSM stage (what is left is finish_proof's host arithmetic and
the batching around it), over the proofs of the window's untraced steps."""


def read(rec):
    steps = rec.get("steps")
    if not steps:
        return None
    tail = sum(s["prove_s"] - s["h_s"] - s["msm_s"] for s in steps)
    return 1000 * tail / sum(s["proofs"] for s in steps)
