"""Device milliseconds per cycle of the cycle's `histogram_blend` stage: both
histograms' update (`calculate_histogram`). Read off the event nodes that mark the
stages inside the cycle's CUDA graph, over the traced stretch's replays of
`tracking_cycle` (harness/stages.py)."""

from benchmark.harness import stages


def read(run):
    return stages.stage_ms("histogram_blend")
