"""host_tail.finish_proof_ms_per_proof: the host time in groth16.finish_proof
(prove_batch's timings["finish_s"], its "host_tail.finish_proof" spans), over
the proofs of the window's untraced steps."""

from benchmark.metrics import program_spans


def read(rec):
    return program_spans.timings_ms(rec, "finish_s")
