"""The scene-query kernel's (K4, query_points_kernel) share of its roofline: the least
time the chip could take for one cycle's calls (benchmark/harness/roofline_scene.py,
from the calls' inputs) over the kernel's device time per cycle (profiler)."""

from benchmark.harness import roofline


def read(run):
    if run.trace is None or run.work is None or run.peaks is None:
        return None
    spent = run.trace.kernel_s("query_points_kernel")
    if not spent or "query_eval" not in run.work:
        return None
    return 100.0 * roofline.bound_s(*run.work["query_eval"], run.peaks) / (
        spent / run.trace.steps)
