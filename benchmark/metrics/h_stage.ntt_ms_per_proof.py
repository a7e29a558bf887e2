"""h_stage.ntt_ms_per_proof: the device time of the rest of the h stage after
the mat-vecs: the pointwise products, the six transforms and the coset
scalings (prove_batch's timings["h_ntt_s"], CUDA events around its "h.ntt"
span), over the proofs of the window's untraced steps."""

from benchmark.metrics import program_spans


def read(rec):
    return program_spans.timings_ms(rec, "h_ntt_s")
