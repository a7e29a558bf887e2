"""Structured metrics (the counterpart of pob_tpu/utils/metrics.py).

- ``MetricsRegistry.stage``: context-manager per-stage wall timings; a
  stage that hands its output in (``holder["out"] = ...``) is timed to the
  end of its device work, by ``torch.cuda.synchronize`` on every card that
  holds a tensor of the output (pob_tpu's ``jax.block_until_ready``).
- ``MetricsRegistry.count``: monotonically increasing named counters
  (proofs, witnesses, constraint evaluations).
- ``MetricsRegistry.report()``: one structured JSON dict, pob_tpu's shape.

Everything is host-side; emitting to a metrics backend is left to the
deployment."""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


def tensor_leaves(tree) -> list:
    """The tensors of a nest of tuples, lists and dict values."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tensor_leaves(x)]
    return []


def synchronize(tree):
    """Wait for the device work of every card that holds a tensor of tree."""
    for dev in {t.device for t in tensor_leaves(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@dataclass
class StageStat:
    count: int = 0
    total_s: float = 0.0
    min_s: float = float("inf")
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.min_s = min(self.min_s, dt)
        self.max_s = max(self.max_s, dt)

    @property
    def mean_s(self) -> float:
        return self.total_s / self.count if self.count else 0.0


@dataclass
class MetricsRegistry:
    stages: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    t_start: float = field(default_factory=time.perf_counter)

    @contextmanager
    def stage(self, name: str, sync=None):
        """Time a pipeline stage. Put the stage's output (any nest of
        tensors) into the yielded dict as "out" to wait for its device work
        before the clock stops."""
        holder = {}
        t0 = time.perf_counter()
        try:
            yield holder
        finally:
            if "out" in holder:
                synchronize(holder["out"])
            dt = time.perf_counter() - t0
            self.stages.setdefault(name, StageStat()).add(dt)

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def rate(self, name: str) -> float:
        """counter / elapsed wall seconds since registry creation."""
        dt = time.perf_counter() - self.t_start
        return self.counters.get(name, 0) / dt if dt > 0 else 0.0

    def report(self) -> dict:
        return {
            "elapsed_s": round(time.perf_counter() - self.t_start, 6),
            "stages": {
                k: {
                    "count": v.count,
                    "mean_s": round(v.mean_s, 6),
                    "min_s": round(v.min_s, 6),
                    "max_s": round(v.max_s, 6),
                    "total_s": round(v.total_s, 6),
                }
                for k, v in self.stages.items()
            },
            "counters": dict(self.counters),
            "rates_per_s": {k: round(self.rate(k), 3) for k in self.counters},
        }

    def dump(self) -> str:
        return json.dumps(self.report())


METRICS = MetricsRegistry()  # process-global default registry
