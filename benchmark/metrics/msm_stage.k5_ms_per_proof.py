"""msm_stage.k5_ms_per_proof: the device time of the MSM stage's K5 sweeps (the
witness queries on the planned path), prove_batch's timings["msm_k5_s"] from
CUDA events around each "msm.k5" span, over the proofs of the window's
untraced steps."""

from benchmark.metrics import program_spans


def read(rec):
    return program_spans.timings_ms(rec, "msm_k5_s")
