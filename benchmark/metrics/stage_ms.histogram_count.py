"""Device milliseconds per cycle of the cycle's `histogram_count` stage: K1 in bins mode
and both K2 calls (`bin_counts_kernel`), with their reshapes. Read off the event nodes
that mark the stages inside the cycle's CUDA graph, over the traced stretch's replays of
`tracking_cycle` (harness/stages.py)."""

from benchmark.harness import stages


def read(run):
    return stages.stage_ms("histogram_count")
