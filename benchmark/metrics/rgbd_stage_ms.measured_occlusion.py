"""Device milliseconds per cycle of the RGB-D cycle's `measured_occlusion` stage: K3
(`sample_windows_kernel`) on the measured-occlusion windows of the region lines
(`_region_measured_occlusion`) and of the depth points (`_depth_terms`), with their
window geometry. Read off the event nodes that mark the stages inside the cycle's
CUDA graph, over the traced stretch's replays of `tracking_cycle_rgbd`
(harness/stages.py); nothing where the program marks no such stage."""

from benchmark.harness import stages

GRAPH = "tracking_cycle_rgbd"


def read(run):
    found = stages.report()
    if found is None or "measured_occlusion" not in found.stages.get(GRAPH, {}):
        return None
    return stages.stage_ms("measured_occlusion", graph=GRAPH)
