"""Host milliseconds per graphed call from its entry to its first enqueue: binding the
arguments, the static key and the graph's lookup (the ``graphs.key`` span over the
traced stretch; harness/stages.py).  Host work the device's next cycle waits on."""

from benchmark.harness import stages


def read(run):
    return stages.span_ms("graphs.key")
