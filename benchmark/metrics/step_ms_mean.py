"""The window's milliseconds over all its steps (host clock)."""


def read(run):
    return run.window_s / len(run.step_s) * 1e3
