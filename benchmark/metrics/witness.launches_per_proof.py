"""witness.launches_per_proof: the kernel launches inside the program's root
witness.* spans of each of the window's untraced steps (their "launches"
attribute), over their proofs (program_spans)."""

from benchmark.metrics import program_spans


def read(rec):
    roots = program_spans.witness_roots(rec)
    if roots is None:
        return None
    n = sum(sum(s.attrs["launches"].values()) for mine in roots for s in mine)
    return n / sum(s["proofs"] for s in rec["steps"])
