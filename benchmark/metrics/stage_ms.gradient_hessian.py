"""Device milliseconds per cycle of the cycle's `gradient_hessian` stage: the region
gradient and Hessian (`region_fast.gradient_hessian_cl`), each update iteration. Read
off the event nodes that mark the stages inside the cycle's CUDA graph, over the traced
stretch's replays of `tracking_cycle` (harness/stages.py)."""

from benchmark.harness import stages


def read(run):
    return stages.stage_ms("gradient_hessian")
