"""Seconds from the start of the run's process to its first timed step (host clock)."""


def read(run):
    return run.setup_s
