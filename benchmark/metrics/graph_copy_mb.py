"""Megabytes (1e6 B) per graphed call that ``_Graph.load`` copied into the graphs'
static buffers (the ``graphs.copy_bytes`` counter over the traced stretch's graphed
calls; harness/stages.py).  A count: the same at every seed."""

from benchmark.harness import stages


def read(run):
    per_call = stages.per_call("graphs.copy_bytes")
    return None if per_call is None else per_call / 1e6
