"""Reading a torch.profiler trace of part of the window: the device's busy
time, the device operations that took most time, and the longest gaps in
which the device was idle, each labelled with the benchmark's span (and the
innermost traced host call, such as a CUDA runtime call) that the host was
in at the gap's middle. The spans are the harness's own host-clock
readings (time.time_ns, the profiler's time base), so the profiler can run
with CUDA activity alone and leave the host's own operations untraced."""

from __future__ import annotations

SPANS = ("witness", "copy", "prove_batch")
TOP = 10


def _device_type(ev) -> str:
    return str(ev.device_type()).rsplit(".", 1)[-1]


def summarize(events, spans) -> dict | None:
    """events: the profiler's kineto events (prof.profiler.kineto_results
    .events()); spans: [(start_ns, end_ns, name)] of the traced steps. None
    when no operation ran on the device (no CUPTI)."""
    dev, host = [], []
    for ev in events:
        s, e = ev.start_ns(), ev.end_ns()
        if e <= s or ev.is_user_annotation() or ev.name() in SPANS:
            continue
        (dev if _device_type(ev) == "CUDA" else host).append((s, e, ev.name()))
    if not dev or not spans:
        return None
    lo = min(s for s, _, _ in spans)
    hi = max(e for _, e, _ in spans)
    busy, gaps = _union(sorted((max(s, lo), min(e, hi)) for s, e, _ in dev
                               if e > lo and s < hi), lo, hi)
    per_op = {}
    for s, e, name in dev:
        per_op[name] = per_op.get(name, 0) + (e - s)
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "busy_s": busy / 1e9,
        "window_s": (hi - lo) / 1e9,
        "device_ops": [[name, ns / 1e9] for name, ns in ops],
        "idle_gaps": [[_label((s + e) // 2, spans, host), (e - s) / 1e9] for s, e in gaps],
    }


def _union(intervals, lo: int, hi: int):
    """Total covered length of sorted intervals, and the gaps inside [lo, hi]."""
    busy, gaps, end = 0, [], lo
    for s, e in intervals:
        if s > end:
            gaps.append((end, s))
            end = s
        if e > end:
            busy += e - max(s, end)
            end = e
    if hi > end:
        gaps.append((end, hi))
    return busy, gaps


def _label(t: int, spans, host) -> str:
    span = next((name for s, e, name in spans if s <= t < e), "between steps")
    inner = None
    for s, e, name in host:
        if s <= t < e and (inner is None or s >= inner[0]):
            inner = (s, name)
    return f"{span}: {inner[1]}" if inner else span
