"""msm_stage.k3_ms_per_proof: the device time of the MSM stage's K3 calls (the
h-MSM on the planned path; every MSM on the plain one), prove_batch's
timings["msm_k3_s"] from CUDA events around each "msm.k3" span, over the
proofs of the window's untraced steps."""

from benchmark.metrics import program_spans


def read(rec):
    return program_spans.timings_ms(rec, "msm_k3_s")
