"""Device-busy milliseconds per cycle that the four hand-written kernels do not take:
the plain-torch glue, copies included (profiler, traced stretch)."""

KERNELS = ("sample_lines_kernel", "bin_counts_kernel", "sample_windows_kernel",
           "query_points_kernel")


def read(run):
    trace = run.trace
    if trace is None or trace.busy_s <= 0:
        return None
    kernels = sum(trace.kernel_s(k) or 0.0 for k in KERNELS)
    return (trace.busy_s - kernels) / trace.steps * 1e3
