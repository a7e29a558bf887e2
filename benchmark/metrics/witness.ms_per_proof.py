"""witness.ms_per_proof: the benchmark's span around the circuit's witness
function and assemble_witness, ended by torch.cuda.synchronize, over the
proofs of the window's untraced steps."""


def read(rec):
    steps = rec.get("steps")
    if not steps or "witness_s" not in steps[0]:  # a loop whose witness is supplied
        return None
    return 1000 * sum(s["witness_s"] for s in steps) / sum(s["proofs"] for s in steps)
