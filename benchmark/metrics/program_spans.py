"""Shared reading of the program's own spans and prove_batch's timings for
the per-layer metrics of the witness's parts and of the stages' parts. Not
a metric: it has no read().

The witness's spans reach the benchmark only through the program's
process-wide registry (pob_tpu_torch.utils.metrics.METRICS), since the
circuit modules call the program's loader, witness and assemble_witness
without a timings argument. The window's untraced steps (rec["steps"]) made
the last prove_batch calls of the run: nothing calls the program after the
window. Each step gets the witness.* spans that start after the previous
root prove_batch span ends and before its own starts. Where the program
keeps no spans (a program without them), the registry dropped some, or the
counts do not match, the metrics are left out."""

from __future__ import annotations


def _registry():
    from pob_tpu_torch.utils import metrics

    reg = metrics.METRICS
    return reg if hasattr(reg, "spans") else None


def witness_spans(rec):
    """[[the step's witness.* spans]] for the window's untraced steps, or None."""
    steps = rec.get("steps")
    reg = _registry()
    if not steps or reg is None:
        return None
    spans = reg.spans()
    if reg.recorded != len(spans):  # the deque dropped spans
        return None
    proves = [s for s in spans if s.parent_id is None and s.name == "prove_batch"]
    if len(proves) < len(steps):
        return None
    prev_end = proves[-len(steps) - 1].end_ns if len(proves) > len(steps) else 0
    wit = [s for s in spans if s.name.startswith("witness.")]
    out = []
    for p in proves[-len(steps):]:
        out.append([s for s in wit if prev_end <= s.start_ns < p.start_ns])
        prev_end = p.end_ns
    if not all(any(s.parent_id is None for s in mine) for mine in out):
        return None
    return out


def _proofs(rec) -> int:
    return sum(s["proofs"] for s in rec["steps"])


def witness_part_ms(rec, name: str):
    """Milliseconds per proof in the steps' spans named `name`."""
    per_step = witness_spans(rec)
    if per_step is None:
        return None
    ns = sum(s.end_ns - s.start_ns for mine in per_step for s in mine if s.name == name)
    return ns / 1e6 / _proofs(rec)


def witness_roots(rec):
    """The steps' root witness.* spans, one list per step, or None."""
    per_step = witness_spans(rec)
    return None if per_step is None else [[s for s in m if s.parent_id is None]
                                           for m in per_step]


def timings_ms(rec, key: str):
    """prove_batch's timings[key] (seconds, summed over its chunks) in
    milliseconds per proof over the window's untraced steps; None where the
    program does not give the key."""
    steps = rec.get("steps")
    if not steps or key not in steps[0]:
        return None
    return 1000 * sum(s[key] for s in steps) / _proofs(rec)
