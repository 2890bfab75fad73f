"""What every cell shares: the specification files, the device record, the trace's
reduction, the kernels' work and the comparison that decides ``correct``."""
