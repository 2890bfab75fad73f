"""Device milliseconds per replay of the copies of the call's arguments into the graph's
static buffers (the ``graphs.copy`` stage, between the event marks around
``_Graph.load``), over the traced stretch's replays of ``tracking_cycle``
(harness/stages.py)."""

from benchmark.harness import stages


def read(run):
    return stages.stage_ms("graphs.copy")
