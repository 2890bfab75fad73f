"""Rows of each structure's KKT system, as the program solves it (NL * 6 + NC * 6 in the
full-width layout): the ``kinematics.kkt_rows`` counter over the ``kinematics.structures``
counter, over the traced stretch's graphed calls (harness/stages.py).  A count: the same
at every seed; fewer rows are less work."""

from benchmark.harness import stages


def read(run):
    found = stages.report()
    structures = found.counters.get("kinematics.structures", 0) if found else 0
    if not structures:
        return None
    return found.counters.get("kinematics.kkt_rows", 0) / structures
