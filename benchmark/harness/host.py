"""The host around the measured window: no garbage collection over the
set-up's objects inside it, and a probe of the host's own speed, reported
beside each run's numbers.

Both cells spend most of a step in host python, and the host's speed moves
from run to run on a machine shared with others, so a run reports how fast
its host was (the probe) beside its rate."""

from __future__ import annotations

import contextlib
import gc
import time

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583


@contextlib.contextmanager
def frozen_gc():
    """Collects the set-up's garbage and freezes what is left (gc.freeze),
    so that no collection in the window walks the set-up's objects (the
    constraint system's, the key's); undone on leaving."""
    gc.collect()
    gc.freeze()
    try:
        yield
    finally:
        gc.unfreeze()


def probe_s(n: int = 1000) -> float:
    """Seconds of n inversions modulo the BN254 base field in python ints:
    the kind of work the program's host tail does."""
    t = time.perf_counter()
    x = 12345678901234567890
    for i in range(n):
        x = pow(x + i, P - 2, P)
    return time.perf_counter() - t
