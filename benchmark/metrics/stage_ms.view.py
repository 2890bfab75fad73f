"""Device milliseconds per cycle of the cycle's `view` stage: the closest view and the
adaptive line count (`_select_view_cl`, `_adaptive_n_lines`), each correspondence
iteration. Read off the event nodes that mark the stages inside the cycle's CUDA graph,
over the traced stretch's replays of `tracking_cycle` (harness/stages.py)."""

from benchmark.harness import stages


def read(run):
    return stages.stage_ms("view")
