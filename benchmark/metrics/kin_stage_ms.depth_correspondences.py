"""Device milliseconds per cycle of the articulated cycle's `depth_correspondences`
stage: the depth crop corners, K3 (`sample_windows_kernel`) and the depth
correspondences with their modeled-occlusion queries
(`depth_fn.calculate_correspondences`). Read off the event nodes that mark the stages
inside the cycle's CUDA graph, over the traced stretch's replays of
`tracking_cycle_kinematic` (harness/stages.py); nothing where the program marks no such
stage."""

from benchmark.harness import stages

GRAPH = "tracking_cycle_kinematic"


def read(run):
    found = stages.report()
    if found is None or "depth_correspondences" not in found.stages.get(GRAPH, {}):
        return None
    return stages.stage_ms("depth_correspondences", graph=GRAPH)
