"""Device milliseconds per cycle of the RGB-D cycle's `texture_gradient_hessian` stage:
the texture matches' Tukey-weighted reprojection terms
(`texture_fn.calculate_gradient_and_hessian`), every update iteration. Read off the
event nodes that mark the stages inside the cycle's CUDA graph, over the traced
stretch's replays of `tracking_cycle_rgbd` (harness/stages.py); nothing where the
program marks no such stage."""

from benchmark.harness import stages

GRAPH = "tracking_cycle_rgbd"


def read(run):
    found = stages.report()
    if found is None or "texture_gradient_hessian" not in found.stages.get(GRAPH, {}):
        return None
    return stages.stage_ms("texture_gradient_hessian", graph=GRAPH)
