"""Device milliseconds per cycle of the articulated cycle's `kinematic_terms` stage:
forward kinematics, the link Jacobians, the constraint terms and the KKT assembly
(`kinematics.update_structures`), each update iteration. Read off the event nodes that
mark the stages inside the cycle's CUDA graph, over the traced stretch's replays of
`tracking_cycle_kinematic` (harness/stages.py); nothing where the program marks no such
stage."""

from benchmark.harness import stages

GRAPH = "tracking_cycle_kinematic"


def read(run):
    found = stages.report()
    if found is None or "kinematic_terms" not in found.stages.get(GRAPH, {}):
        return None
    return stages.stage_ms("kinematic_terms", graph=GRAPH)
