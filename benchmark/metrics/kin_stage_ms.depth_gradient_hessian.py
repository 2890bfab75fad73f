"""Device milliseconds per cycle of the articulated cycle's `depth_gradient_hessian`
stage: the point-to-plane gradient and Hessian of every link
(`depth_fn.calculate_gradient_and_hessian`), each update iteration. Read off the event
nodes that mark the stages inside the cycle's CUDA graph, over the traced stretch's
replays of `tracking_cycle_kinematic` (harness/stages.py); nothing where the program
marks no such stage."""

from benchmark.harness import stages

GRAPH = "tracking_cycle_kinematic"


def read(run):
    found = stages.report()
    if found is None or "depth_gradient_hessian" not in found.stages.get(GRAPH, {}):
        return None
    return stages.stage_ms("depth_gradient_hessian", graph=GRAPH)
