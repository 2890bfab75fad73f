"""Per-phase execution timing (port of m3t_tpu/utils/timing.py; a redesign of the
evaluators' ExecutionTimes instrumentation, rbot_evaluator.h:50-56 /
ycb_evaluator.cpp:591-680).

Named spans accumulate wall-clock per phase; with ``use_profiler_ranges`` each span is
also a ``torch.profiler.record_function`` range, so that phases show up in profiler
timelines.  Spans time the host: a span around work on the card measures what the host
waited for only where that work ends in a synchronizing read.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class ExecutionTimer:
    """Accumulates per-phase durations: correspondences, gradient_and_hessian,
    optimization, results, complete_cycle."""

    def __init__(self, use_profiler_ranges: bool = False):
        self.use_profiler_ranges = use_profiler_ranges
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.use_profiler_ranges:
            import torch.profiler

            ctx = torch.profiler.record_function(name)
        else:
            ctx = contextlib.nullcontext()
        begin = time.perf_counter()
        with ctx:
            yield
        elapsed = time.perf_counter() - begin
        self.totals[name] += elapsed
        self.counts[name] += 1

    def mean(self, name: str) -> float:
        if self.counts[name] == 0:
            return 0.0
        return self.totals[name] / self.counts[name]

    def summary(self) -> dict:
        return {name: {"total_s": self.totals[name], "count": self.counts[name],
                       "mean_s": self.mean(name)} for name in self.totals}

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


def timed_tracking_cycle(tracker, iteration: int, timer: ExecutionTimer) -> bool:
    """Run one tracking cycle with the reference's per-phase breakdown
    (mirrors RBOTEvaluator::ExecuteMeasuredTrackingCycle)."""
    with timer.span("complete_cycle"):
        for corr_iteration in range(tracker.n_corr_iterations):
            with timer.span("calculate_correspondences"):
                if not tracker.CalculateCorrespondences(iteration, corr_iteration):
                    return False
            for update_iteration in range(tracker.n_update_iterations):
                with timer.span("calculate_gradient_and_hessian"):
                    if not tracker.CalculateGradientAndHessian(
                            iteration, corr_iteration, update_iteration):
                        return False
                with timer.span("calculate_optimization"):
                    if not tracker.CalculateOptimization(
                            iteration, corr_iteration, update_iteration):
                        return False
        with timer.span("calculate_results"):
            if not tracker.CalculateResults(iteration):
                return False
    return True
