"""Reduction of a torch.profiler window to what the per-layer metrics read.

The traced run profiles a steady stretch of its window (``trace_steps`` steps), each step
inside a ``bench.step`` range, and keeps the reduction in memory: device busy time (the
union of the device's kernel and copy intervals), the traced wall, device time by
operation name, the longest idle gaps named by what the host was doing, and the host
ranges that the drivers open.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

STEP = "bench.step"
# Host calls that wait for the device or a copy (cudaMemcpy*: a copy from pageable
# memory, or to the host, blocks the host): the time a step spends in them is not host
# work.
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
         "cudaMemcpy")


class Trace(NamedTuple):
    steps: int
    window_s: float         # first traced step's start to the last one's end
    busy_s: float           # union of device intervals inside the window
    device_s: dict          # device seconds by operation name
    gaps: list              # [(host activity, seconds)] longest idle gaps first
    ranges: dict            # host range name -> [(start_us, end_us)]
    waits: list             # [(start_us, end_us)] host calls that wait (WAITS)

    def kernel_s(self, fragment: str) -> float | None:
        """Device seconds of the operations whose name contains ``fragment``."""
        hits = [s for name, s in self.device_s.items() if fragment in name]
        return sum(hits) if hits else None

    def breakdown(self) -> dict:
        ops = sorted(self.device_s.items(), key=lambda kv: kv[1], reverse=True)[:10]
        return {"device_ops": [[name[:120], s] for name, s in ops],
                "idle_gaps": [[name[:120], s] for name, s in self.gaps[:10]]}


def _merge(intervals):
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _is_device(event) -> bool:
    """A kernel, copy or set on the device; the device-side marks of the host's
    ``record_function`` ranges (user annotations) are not work."""
    return (str(event.device_type).endswith("CUDA")
            and not getattr(event, "is_user_annotation", False))


def _is_annotation(event) -> bool:
    return (str(event.device_type).endswith("CUDA")
            and getattr(event, "is_user_annotation", False))


def reduce(events) -> Trace:
    """Trace of a profiler's ``events()`` (FunctionEvents, times in microseconds)."""
    events = [e for e in events if not _is_annotation(e)]
    steps = [(e.time_range.start, e.time_range.end) for e in events
             if not _is_device(e) and e.name == STEP]
    if not steps:
        raise ValueError(f"the profiled window holds no {STEP!r} range")
    lo, hi = min(s for s, _ in steps), max(e for _, e in steps)
    device, device_s = [], {}
    for e in events:
        if _is_device(e):
            start, end = max(e.time_range.start, lo), min(e.time_range.end, hi)
            if end > start:
                device.append((start, end))
                device_s[e.name] = device_s.get(e.name, 0.0) + (end - start) * 1e-6
    busy = _merge(device)
    host = [e for e in events if not _is_device(e) and e.name != STEP]
    ranges, waits = {STEP: sorted(steps)}, []
    for e in host:
        ranges.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
        if e.name.startswith(WAITS):
            waits.append((e.time_range.start, e.time_range.end))
    gaps, cursor = [], lo
    for start, end in busy + [[hi, hi]]:
        if start > cursor:
            gaps.append((cursor, start))
        cursor = max(cursor, end)

    def doing(gap):
        mid = 0.5 * (gap[0] + gap[1])
        inside = [e for e in host if e.time_range.start <= mid <= e.time_range.end]
        if not inside:
            return "no host range"
        return min(inside, key=lambda e: e.time_range.end - e.time_range.start).name

    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    return Trace(len(steps), (hi - lo) * 1e-6, sum(e - s for s, e in busy) * 1e-6,
                 device_s, [(doing(g), (g[1] - g[0]) * 1e-6) for g in gaps[:10]], ranges,
                 waits)


def step_range(traced: bool):
    """The ``bench.step`` range around one step of a traced stretch."""
    if not traced:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(STEP)


def host_range(name: str, traced: bool):
    if not traced:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(name)
