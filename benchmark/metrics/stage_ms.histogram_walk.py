"""Device milliseconds per cycle of the cycle's `histogram_walk` stage: the last view
and the histogram walk's geometry (`histogram_walk_geometry`, its int64 `cumprod`). Read
off the event nodes that mark the stages inside the cycle's CUDA graph, over the traced
stretch's replays of `tracking_cycle` (harness/stages.py)."""

from benchmark.harness import stages


def read(run):
    return stages.stage_ms("histogram_walk")
