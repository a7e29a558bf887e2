"""step_mfu: the least time of the prove's counted work (the h stage's and
the MSM stage's, as their rooflines count it) over the whole step's time
(the loop's "step_s": the witness or the copy, and prove_batch), for the
window's untraced steps. The witness's own work is not counted, so this is
the share of the card's peak that the counted work alone would need."""

from benchmark.metrics import roofline


def read(rec):
    steps = rec.get("steps")
    least = [roofline.least_s(rec, stage) for stage in ("h_stage", "msm_stage")]
    if not steps or None in least:
        return None
    proofs = sum(s["proofs"] for s in steps)
    return 100 * proofs * sum(t for t, _ in least) / sum(s["step_s"] for s in steps)
