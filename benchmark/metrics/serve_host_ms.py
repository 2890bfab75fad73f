"""Host milliseconds per live step outside the cycle's replay: each traced step's wall
less the cycle call's host time and the host's waits for the device outside it
(profiler ranges that the tracker_loop driver opens, no synchronize)."""

from benchmark.harness.trace import STEP

CYCLE = "serve.cycle"


def _inside(spans, lo, hi):
    return [(s, e) for s, e in spans if s >= lo and e <= hi]


def read(run):
    trace = run.trace
    if trace is None or CYCLE not in trace.ranges:
        return None
    host_us = []
    for lo, hi in trace.ranges[STEP]:
        cycles = _inside(trace.ranges[CYCLE], lo, hi)
        waits = [(s, e) for s, e in _inside(trace.waits, lo, hi)
                 if not any(cs <= s and e <= ce for cs, ce in cycles)]
        host_us.append((hi - lo) - sum(e - s for s, e in cycles + waits))
    return sum(host_us) / len(host_us) * 1e-3
