"""Closed loop, the witness made in every step: the next batch of fresh
inputs from the configuration's pool, the circuit's witness on the card,
then prove_batch with blinding drawn from the seed. Spans: "witness" (ended
by a synchronize) and "prove_batch"."""

from __future__ import annotations

import time

from benchmark.harness import closed


def step(ctx, k: int, timed: bool) -> closed.Step:
    B, pool = ctx.traffic["batch"], ctx.pool
    items = [ctx.gen.fresh(pool[(k * B + j) % len(pool)], ctx.rng["fresh"]) for j in range(B)]
    rs = ctx.blinding(B)
    if not timed:
        W = ctx.circuit.witness(items, ctx.device)
        return closed.Step(items, rs, W, ctx.groth16.prove_batch(ctx.pk, W, rs=rs), None)
    tm = {}
    t0, n0 = time.perf_counter(), time.time_ns()
    W = ctx.circuit.witness(items, ctx.device)
    ctx.sync()
    t1, n1 = time.perf_counter(), time.time_ns()
    proofs = ctx.groth16.prove_batch(ctx.pk, W, rs=rs, timings=tm)
    t2, n2 = time.perf_counter(), time.time_ns()
    ctx.spans.extend([(n0, n1, "witness"), (n1, n2, "prove_batch")])
    return closed.Step(items, rs, W, proofs,
                       dict(tm, witness_s=t1 - t0, prove_s=t2 - t1, step_s=t2 - t0))


def prepare(ctx):
    closed.prepare(ctx, step)


def window(ctx, seconds: float) -> dict:
    return closed.window(ctx, step, seconds)
