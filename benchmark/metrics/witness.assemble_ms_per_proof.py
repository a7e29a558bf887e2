"""witness.assemble_ms_per_proof: the host time of the program's "witness.assemble"
spans in each of the window's untraced steps, over their proofs
(program_spans)."""

from benchmark.metrics import program_spans


def read(rec):
    return program_spans.witness_part_ms(rec, "witness.assemble")
