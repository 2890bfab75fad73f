"""Share of the traced run's window in which the device ran no part of the cycle: the
cycles' seconds over the window's seconds, both read off the device's clock (CUDA events
on the stream at each step's start and around each cycle call, the window untraced).
Between two cycles the device runs only the steps' small copies (frame in, poses out)."""


def read(run):
    if run.device_split is None:
        return None
    inside, span = run.device_split
    return 100.0 * (1.0 - inside / span) if span > 0 else None
