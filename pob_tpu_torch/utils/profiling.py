"""Timing harness (the counterpart of pob_tpu/utils/profiling.py)."""

from __future__ import annotations

import time
from dataclasses import dataclass

from .metrics import synchronize, tensor_leaves


@dataclass
class BenchResult:
    name: str
    seconds_per_iter: float
    iters: int
    items_per_iter: int = 1

    @property
    def items_per_sec(self) -> float:
        return self.items_per_iter / self.seconds_per_iter

    def __str__(self):
        return (
            f"{self.name}: {self.seconds_per_iter*1e3:.3f} ms/iter, "
            f"{self.items_per_sec:,.1f} items/s"
        )


def bench_fn(name, fn, *args, iters: int = 10, items_per_iter: int = 1,
             warmup: int = 1, **kw) -> BenchResult:
    """Time a function with device synchronization: after the warm-up and
    after the timed iterations, the output's cards are synchronized and one
    element of its first tensor is fetched to the host (pob_tpu's barrier:
    the element depends on the whole result)."""

    def sync(o):
        synchronize(o)
        leaves = tensor_leaves(o)
        if leaves:
            leaves[0][(0,) * leaves[0].dim()].cpu()

    for _ in range(warmup):
        out = fn(*args, **kw)
    sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args, **kw)
    sync(out)
    dt = (time.perf_counter() - t0) / iters
    return BenchResult(name, dt, iters, items_per_iter)
