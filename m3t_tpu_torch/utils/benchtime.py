"""Robust multi-window benchmark timing (a copy of m3t_tpu/utils/benchtime.py).

A single timed window can be poisoned by a slow phase of the host or the device that has
nothing to do with the code under test (a card's machine shares its host CPU cores with
other work).  The policy:

  * take several independent timed windows and report the MEDIAN rate (robust to a
    minority of pathological windows),
  * publish min/max spread next to the median so a dispersed record is visibly dispersed,
  * when windows disagree by more than ``dispersion_limit``, keep measuring extra
    windows up to a bounded retry budget and flag ``unstable`` if the disagreement
    persists.

The policy is pure (takes a ``timed_window`` callable) so it is unit-testable without a
device: an injected slow window must not move the median.
"""

from __future__ import annotations

import statistics
from typing import Callable, NamedTuple


class WindowStats(NamedTuple):
    """Result of a multi-window measurement (all times in seconds per window)."""

    median_s: float
    min_s: float
    max_s: float
    times: tuple
    unstable: bool
    n_extra: int

    def rate(self, work_per_window: float) -> float:
        """Median rate in (work units)/s for ``work_per_window`` units per window."""
        return work_per_window / self.median_s

    def rate_spread(self, work_per_window: float) -> tuple:
        """(min, max) rate across windows — max time gives the min rate."""
        return work_per_window / self.max_s, work_per_window / self.min_s


def _dispersion(times) -> float:
    return max(times) / max(min(times), 1e-12)


def _settled(times, dispersion_limit: float) -> bool:
    """True when the windows agree — a SINGLE worst outlier among >= 4 windows
    is forgiven (one transient slow window must not poison the run or burn the
    whole retry budget; persistent disagreement still fails this check)."""
    if len(times) <= 1:
        return True
    if _dispersion(times) <= dispersion_limit:
        return True
    if len(times) >= 4:
        trimmed = sorted(times)[:-1]
        return _dispersion(trimmed) <= dispersion_limit
    return False


def measure_windows(timed_window: Callable[[], float], n_windows: int = 5,
                    max_extra: int = 5,
                    dispersion_limit: float = 2.0) -> WindowStats:
    """Run ``timed_window`` (returns elapsed seconds for a fixed amount of work)
    ``n_windows`` times, retrying with up to ``max_extra`` additional windows while
    the windows disagree by more than ``dispersion_limit`` (one worst outlier among
    >= 4 windows is disregarded by the settling check, but stays in the published
    spread)."""
    if n_windows < 1:
        raise ValueError("n_windows must be >= 1")
    times = [float(timed_window()) for _ in range(n_windows)]
    n_extra = 0
    while not _settled(times, dispersion_limit) and n_extra < max_extra:
        times.append(float(timed_window()))
        n_extra += 1
    unstable = not _settled(times, dispersion_limit)
    return WindowStats(median_s=statistics.median(times), min_s=min(times),
                       max_s=max(times), times=tuple(times), unstable=unstable,
                       n_extra=n_extra)


def measure_with_floor(timed_window: Callable[[], float], work_per_window: float,
                       floor_rate: float = 0.0, n_windows: int = 5,
                       max_extra: int = 5, dispersion_limit: float = 2.0,
                       max_rounds: int = 3,
                       pause: Callable[[], None] = None) -> WindowStats:
    """measure_windows plus a whole-run sanity floor.

    A pathological slow phase can slow EVERY window of one run, which per-window
    medians cannot detect.  When the median rate of a full measurement round falls below
    ``floor_rate`` (a conservative fraction of the known-good rate for the workload),
    the measurement is re-run after ``pause()`` up to ``max_rounds`` total rounds and the
    best (fastest-median) round wins; if every round stays below the floor the best
    round is returned with ``unstable=True``.
    """
    best = None
    for _ in range(max(max_rounds, 1)):
        stats = measure_windows(timed_window, n_windows, max_extra, dispersion_limit)
        if best is None or stats.median_s < best.median_s:
            best = stats
        if floor_rate <= 0.0 or best.rate(work_per_window) >= floor_rate:
            return best
        if pause is not None:
            pause()
    return best._replace(unstable=True)
