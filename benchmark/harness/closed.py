"""A closed loop: the steps of a loop module back to back, one batch at a
time, each started as the last one ends.

A loop module (benchmark/loops/<name>.py, named by its traffic file's
"loop") gives step(ctx, k, timed) -> Step for step k of the run, counting
the warm-up's; this module warms it up and runs its window. A timed step
gives its record: the program's own timings of prove_batch, whole, and the
loop's spans in seconds, "step_s" the whole step's."""

from __future__ import annotations

import time
from typing import NamedTuple

from benchmark.harness import keep
from benchmark.harness import trace as tracemod


class Step(NamedTuple):
    items: list  # the batch's inputs, in the reference's format
    rs: list  # each proof's (r, s)
    W: object  # the (B, num_wires, 16) witness the proofs were made from
    proofs: list
    times: dict | None  # the step's record; None for an untimed step


def prepare(ctx, step):
    """Warm-up steps of the window's shapes, then the keeper's host buffers."""
    for k in range(ctx.traffic["warmup_steps"]):
        W = step(ctx, k, ctx.trace).W
    ctx.keeper = keep.Keeper(ctx.torch, W, ctx.traffic["check_steps"], ctx.rng["sample"],
                             ctx.cuda)
    ctx.first_step = ctx.traffic["warmup_steps"]


def window(ctx, step, seconds: float) -> dict:
    """Steps until one ends after `seconds`. With ctx.trace, torch.profiler
    (CUDA activity only) traces the first trace_steps steps, whose records
    are left out of ctx.rec["steps"]."""
    torch, B = ctx.torch, ctx.traffic["batch"]
    n_traced = ctx.traffic["trace_steps"] if ctx.trace else 0
    prof, traced_spans = None, []
    if n_traced:
        act = torch.profiler.ProfilerActivity
        prof = torch.profiler.profile(activities=[act.CUDA if ctx.cuda else act.CPU])
        ctx.spans.clear()
        prof.start()
    done = attempted = 0
    ends = []
    t_w = time.perf_counter()
    while True:
        i = len(ends)
        s = step(ctx, ctx.first_step + i, ctx.trace)
        ends.append(time.perf_counter() - t_w)
        n_ok = sum(p is not None for p in s.proofs[:B])
        attempted += B
        done += n_ok
        if s.times is not None and i >= n_traced:
            ctx.rec["steps"].append(dict(s.times, proofs=n_ok))
        ctx.keeper.offer(i, s.items, s.rs, s.W, s.proofs)
        del s
        if prof is not None and i + 1 == n_traced:
            prof.stop()
            traced_spans = list(ctx.spans)
        if ends[-1] >= seconds:
            break
    if prof is not None and len(ends) < n_traced:
        prof.stop()
        traced_spans = list(ctx.spans)
    out = {"done": done, "attempted": attempted, "window_s": ends[-1], "ends": ends}
    if prof is not None:
        out["trace"] = tracemod.summarize(prof.profiler.kineto_results.events(), traced_spans)
    return out
