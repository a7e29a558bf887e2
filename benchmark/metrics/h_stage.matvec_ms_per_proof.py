"""h_stage.matvec_ms_per_proof: the device time of the h stage's two sparse
mat-vecs (prove_batch's timings["h_matvec_s"], CUDA events around its
"h.matvec" span) over the proofs of the window's untraced steps."""

from benchmark.metrics import program_spans


def read(rec):
    return program_spans.timings_ms(rec, "h_matvec_s")
