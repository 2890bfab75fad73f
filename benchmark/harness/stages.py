"""What the program's tracer (``m3t_tpu_torch.utils.timing``) kept over the traced
stretch, for the per-layer metrics that read it.

The tracer is on exactly while ``run.py``'s profiler runs, so ``timing.report()`` read
after the run holds the stretch's graphed calls: each cycle's stages timed by the event
nodes inside its graph, on the device's clock (the copies into the graph's buffers, its
own stages and the outputs' clones), the graphs' counters and their host spans.  A
program without the tracer's report, or a stretch that made no call of the graph,
gives None.
"""

from __future__ import annotations

CYCLE = "tracking_cycle"


def report():
    """The tracer's report, or None where the program has none."""
    from m3t_tpu_torch.utils import timing

    read = getattr(timing, "report", None)
    return None if read is None else read()


def stage_ms(stage: str, graph: str = CYCLE) -> float | None:
    """Device milliseconds of ``stage`` summed over each traced call of ``graph``, over
    those calls (0 where the calls ran no such stage)."""
    found = report()
    if found is None or not found.calls.get(graph):
        return None
    seconds = found.stages.get(graph, {}).get(stage, (0.0, 0))[0]
    return seconds / found.calls[graph] * 1e3


def per_call(counter: str) -> float | None:
    """A counter of the graphs over the traced graphed calls (0 where nothing was
    counted)."""
    found = report()
    calls = sum(found.calls.values()) if found is not None else 0
    if not calls:
        return None
    return found.counters.get(counter, 0) / calls


def span_ms(name: str) -> float | None:
    """Mean host milliseconds of the spans named ``name``."""
    found = report()
    spans = [s for s in found.spans if s.name == name] if found is not None else []
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / len(spans) * 1e-6
