"""The 95th percentile of every step of the window, in milliseconds (host clock)."""

import statistics


def read(run):
    return statistics.quantiles([s * 1e3 for s in run.step_s], n=20)[18]
