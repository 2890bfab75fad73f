"""The plain reference that decides a run's ``correct``: M3T's region tracking cycle
written out in plain PyTorch (``region.py``), independent of the program.  It imports
nothing of the program and receives only the configuration, the frames, the benchmark's
region model and the state it steps from.
"""
