"""Closed loop, the witness supplied: set-up makes one witness for each
input of the pool (each with its fresh part) and keeps it on the host, as a
prover fed witness files from another generator holds them; each step
copies the next batch's witnesses to the card and calls prove_batch with
fresh blinding drawn from the seed. Spans: "copy" (ended by a synchronize)
and "prove_batch"."""

from __future__ import annotations

import time

from benchmark.harness import closed


def step(ctx, k: int, timed: bool) -> closed.Step:
    B, P = ctx.traffic["batch"], len(ctx.supplied)
    picks = [ctx.supplied[(k * B + j) % P] for j in range(B)]
    items = [item for item, _ in picks]
    rs = ctx.blinding(B)
    t0, n0 = time.perf_counter(), time.time_ns()
    parts = [w.to(ctx.device, non_blocking=True) for _, w in picks]
    W = parts[0] if B == 1 else ctx.torch.cat(parts)
    if not timed:
        return closed.Step(items, rs, W, ctx.groth16.prove_batch(ctx.pk, W, rs=rs), None)
    tm = {}
    ctx.sync()
    t1, n1 = time.perf_counter(), time.time_ns()
    proofs = ctx.groth16.prove_batch(ctx.pk, W, rs=rs, timings=tm)
    t2, n2 = time.perf_counter(), time.time_ns()
    ctx.spans.extend([(n0, n1, "copy"), (n1, n2, "prove_batch")])
    return closed.Step(items, rs, W, proofs,
                       dict(tm, copy_s=t1 - t0, prove_s=t2 - t1, step_s=t2 - t0))


def prepare(ctx):
    ctx.supplied = []
    for item in ctx.pool:
        item = ctx.gen.fresh(item, ctx.rng["fresh"])
        W = ctx.circuit.witness([item], ctx.device)
        host = ctx.torch.empty(W.shape, dtype=W.dtype, pin_memory=ctx.cuda)
        host.copy_(W)
        ctx.supplied.append((item, host))
        del W
    closed.prepare(ctx, step)


def window(ctx, seconds: float) -> dict:
    return closed.window(ctx, step, seconds)
