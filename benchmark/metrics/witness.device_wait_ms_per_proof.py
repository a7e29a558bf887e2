"""witness.device_wait_ms_per_proof: how long the host waited for the card at
the witness's end: the loop's synchronized witness span (witness_s) less the
program's root witness.* spans in the step (program_spans), over the proofs
of the window's untraced steps. Work outside those spans (Spend's copy of
its inputs to the card) counts here too."""

from benchmark.metrics import program_spans


def read(rec):
    roots = program_spans.witness_roots(rec)
    if roots is None or "witness_s" not in rec["steps"][0]:
        return None
    ns = sum(s.end_ns - s.start_ns for mine in roots for s in mine)
    wait = sum(s["witness_s"] for s in rec["steps"]) - ns / 1e9
    return 1000 * wait / sum(s["proofs"] for s in rec["steps"])
