"""Body-frames the window completed (a link counts as a body) over its seconds (host
clock, each step ending in a host read of the poses)."""


def read(run):
    return len(run.step_s) * run.driver.units_per_step / run.window_s
