"""Device milliseconds per cycle of the RGB-D cycle's `depth_correspondences` stage: the
depth crop corners, the closest depth view, K3 on the correspondence windows and the
depth correspondences with their measured-occlusion test
(`depth_fn.calculate_correspondences`). Read off the event nodes that mark the stages
inside the cycle's CUDA graph, over the traced stretch's replays of
`tracking_cycle_rgbd` (harness/stages.py); nothing where the program marks no such
stage."""

from benchmark.harness import stages

GRAPH = "tracking_cycle_rgbd"


def read(run):
    found = stages.report()
    if found is None or "depth_correspondences" not in found.stages.get(GRAPH, {}):
        return None
    return stages.stage_ms("depth_correspondences", graph=GRAPH)
