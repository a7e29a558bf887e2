"""Structured metrics (the counterpart of pob_tpu/utils/metrics.py), and the
port's spans.

- ``MetricsRegistry.span``: a context manager that records one finished
  span, ``Span(id, parent_id, name, start_ns, end_ns, attrs)``, in a
  bounded in-memory deque read by ``spans()``. Times are on
  ``time.time_ns()``'s base, torch.profiler's, so a trace's device events
  can be placed inside the spans; the parent is the innermost open span of
  the calling thread; ``attrs["launches"]`` holds the kernels launched
  inside the span (the nonzero deltas of ``_build.LAUNCHES``). A span never
  synchronizes the device. ``enabled = False`` records nothing.
- ``traced(name)``: a decorator that makes each call of a function a span
  of ``METRICS``, the process-wide registry.
- ``MetricsRegistry.stage``: a span whose end waits for the device work of
  the output handed in (``holder["out"] = ...``), by
  ``torch.cuda.synchronize`` on every card that holds a tensor of it
  (pob_tpu's ``jax.block_until_ready``).
- ``MetricsRegistry.count``: monotonically increasing named counters
  (proofs, witnesses, constraint evaluations).
- ``MetricsRegistry.report()``: one structured JSON dict, pob_tpu's shape;
  every span and stage adds its seconds to ``stages[name]``.
- ``DeviceLaps``: device seconds of named parts of a stream of work (CUDA
  events on a card, read once the host has synchronized past them; the
  host clock on the CPU, where torch ops are synchronous).

Everything is host-side; emitting to a metrics backend is left to the
deployment."""

from __future__ import annotations

import functools
import itertools
import json
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from .. import _build

MAX_SPANS = 65536


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


def launches_since(before: dict) -> dict:
    """Kernel launches since the copy `before` of _build.LAUNCHES, nonzero only."""
    return {k: v - before[k] for k, v in _build.LAUNCHES.items() if v != before[k]}


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


class Span(NamedTuple):
    id: int
    parent_id: int | None
    name: str
    start_ns: int  # time.time_ns() base
    end_ns: int
    attrs: dict


@dataclass
class MetricsRegistry:
    stages: dict = field(default_factory=dict)
    counters: dict = field(default_factory=dict)
    t_start: float = field(default_factory=time.perf_counter)

    def __post_init__(self):
        self.enabled = True
        self.recorded = 0  # spans ever recorded; those beyond MAX_SPANS were dropped
        self._spans = deque(maxlen=MAX_SPANS)
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        # perf_counter_ns + this = time.time_ns()'s base
        self._epoch_ns = time.time_ns() - time.perf_counter_ns()

    def span(self, name: str, **attrs) -> "_OpenSpan":
        """Record the block as one span named `name`; attrs are kept with it
        (the dict the block gets from `with`, which gains "launches" at the
        end)."""
        return _OpenSpan(self, name, attrs)

    def spans(self) -> list:
        """The kept spans (Span), oldest first, each recorded as it ended."""
        return [Span._make(t) for t in self._spans]

    @contextmanager
    def stage(self, name: str, sync=None):
        """Time a pipeline stage. Put the stage's output (any nest of
        tensors) into the yielded dict as "out" to wait for its device work
        before the clock stops."""
        holder = {}
        with self.span(name):
            try:
                yield holder
            finally:
                if "out" in holder:
                    synchronize(holder["out"])

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


class _OpenSpan:
    """A span while its block runs (a class, not a generator, for its cost:
    two clock reads, one copy of the launch counters and one append)."""

    __slots__ = ("reg", "name", "attrs", "stack", "sid", "parent", "before", "t0")

    def __init__(self, reg: MetricsRegistry, name: str, attrs: dict):
        self.reg, self.name, self.attrs, self.stack = reg, name, attrs, None

    def __enter__(self) -> dict:
        reg = self.reg
        if reg.enabled:
            self.stack = stack = reg._local.__dict__.setdefault("stack", [])
            self.sid = next(reg._ids)
            self.parent = stack[-1] if stack else None
            stack.append(self.sid)
            self.before = dict(_build.LAUNCHES)
            self.t0 = time.perf_counter_ns()
        return self.attrs

    def __exit__(self, *exc) -> bool:
        if self.stack is None:
            return False
        t1 = time.perf_counter_ns()
        self.stack.pop()
        self.attrs["launches"] = launches_since(self.before)
        reg, epoch = self.reg, self.reg._epoch_ns
        with reg._lock:
            reg._spans.append((self.sid, self.parent, self.name, self.t0 + epoch, t1 + epoch,
                               self.attrs))
            reg.recorded += 1
            reg.stages.setdefault(self.name, StageStat()).add((t1 - self.t0) / 1e9)
        return False


METRICS = MetricsRegistry()  # process-global default registry


def traced(name: str):
    """Decorator: every call of the function is one METRICS span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            with METRICS.span(name):
                return fn(*args, **kw)
        return call
    return wrap


class DeviceLaps:
    """Device seconds of named parts of the work on `device`'s current
    stream, summed by key. On a card each part is a pair of CUDA events,
    read by read() once the host has synchronized past them; on the CPU,
    where torch ops are synchronous, the host clock."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.totals: dict = {}
        self._pending = []

    @contextmanager
    def part(self, key: str):
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.totals[key] = self.totals.get(key, 0.0) + time.perf_counter() - t0
            return
        stream = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        try:
            yield
        finally:
            end = torch.cuda.Event(enable_timing=True)
            end.record(stream)
            self._pending.append((key, start, end))

    def read(self) -> dict:
        """The totals, once the device has passed every part's end."""
        for key, start, end in self._pending:
            self.totals[key] = self.totals.get(key, 0.0) + start.elapsed_time(end) / 1e3
        self._pending.clear()
        return self.totals


def lap(laps: DeviceLaps | None, key: str):
    """laps.part(key), or nothing without laps."""
    return nullcontext() if laps is None else laps.part(key)
