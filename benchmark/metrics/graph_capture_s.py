"""Seconds the program spent capturing its CUDA graphs at set-up: each graph's first,
eager run and its capture (graphs.captured(), GraphInfo.warmup_s + capture_s)."""


def read(run):
    return run.driver.graph_capture_s or None
