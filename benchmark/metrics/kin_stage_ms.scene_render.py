"""Device milliseconds per cycle of the articulated cycle's `scene_render` stage: the
links' focused scenes at the current poses (`occlusion.focused_scene_coeffs`: the crops,
the meshes posed by batched 3x3 matmuls, the triangles' plane coefficients and their
valid-first sort), each correspondence iteration; K4 itself runs in the `line_geometry`
and `depth_correspondences` stages. Read off the event nodes that mark the stages inside
the cycle's CUDA graph, over the traced stretch's replays of `tracking_cycle_kinematic`
(harness/stages.py); nothing where the program marks no such stage."""

from benchmark.harness import stages

GRAPH = "tracking_cycle_kinematic"


def read(run):
    found = stages.report()
    if found is None or "scene_render" not in found.stages.get(GRAPH, {}):
        return None
    return stages.stage_ms("scene_render", graph=GRAPH)
