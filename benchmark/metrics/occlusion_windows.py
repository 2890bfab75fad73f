"""Measured-occlusion windows that K3 presamples in one RGB-D cycle, the region lines'
and the depth points' together: the ``depth.occlusion_windows`` counter over the traced
stretch's graphed calls of ``tracking_cycle_rgbd`` (harness/stages.py).  A count: the
same at every seed; fewer windows are less work, and a cycle that skips the check reads
fewer."""

from benchmark.harness import stages

GRAPH = "tracking_cycle_rgbd"


def read(run):
    found = stages.report()
    calls = found.calls.get(GRAPH, 0) if found else 0
    if not calls or "depth.occlusion_windows" not in found.counters:
        return None
    return found.counters["depth.occlusion_windows"] / calls
