"""Device milliseconds per cycle of the cycle's `sample_lines` stage: K1 in ratio mode
(`sample_lines_kernel`), each correspondence iteration. Read off the event nodes that
mark the stages inside the cycle's CUDA graph, over the traced stretch's replays of
`tracking_cycle` (harness/stages.py)."""

from benchmark.harness import stages


def read(run):
    return stages.stage_ms("sample_lines")
