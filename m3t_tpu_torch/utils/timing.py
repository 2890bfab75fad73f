"""The port's tracer, and per-phase execution timing (port of m3t_tpu/utils/timing.py; a
redesign of the evaluators' ExecutionTimes instrumentation, rbot_evaluator.h:50-56 /
ycb_evaluator.cpp:591-680).

The tracer is on inside :func:`tracing`, and while a torch profiler runs; otherwise it is
off, and a span, a counter or a mark costs one flag check and records nothing.

Host spans (:func:`span`).  Each span records its name, its start and end on
``time.perf_counter_ns()``, the id of the span it is nested in and a step id: the one
given to it or to a span around it (the Tracker's iteration), else the sequence number of
the graphed call it is in.  Spans are kept in memory in a bounded buffer.  While a
profiler runs, each span is also a ``torch.profiler.record_function`` range, so the
profiler's timeline shows it beside the kernels.  A span times the host: around work on
the card it measures what the host waited for only where that work ends in a
synchronizing read.

Counters (:func:`count`) add while the tracer is on.  A count made inside a graphed
function is taken into its graph at the capture, and each replay adds it again, so a
graphed call counts what its eager twin counts.  Counts that a kernel makes on the card
go to a :func:`device_tally`, which the report reads; work captured into a graph gets no
tally, so its replays add nothing there.

Device marks (:func:`stage`).  A graphed call (``graphs.graphed``) opens a call record,
and ``stage(name)`` marks where, on the device's stream, the call's work passes to the
stage ``name``; ``stage(None)`` ends the open stage without opening another.  Every
operation between two marks belongs to the first one's stage.  A replay runs no Python,
so the marks of a graphed function are taken into its graph: inside a capture a mark is a
``torch.cuda.Event(enable_timing=True, external=True)``, which the capture records as an
event-record node, whatever the tracer's state (one graph serves both); the graph keeps
its marks, and each replay records them anew.  Eagerly on the card with the tracer on, a
mark is an ordinary timing event; on the CPU it is a host timestamp.  With the tracer off
and no capture running a mark does nothing.

One clock.  When the tracer turns on it synchronizes the card once and records an anchor
event between two host clock reads (the tightest of a few tries); every event is then
placed on ``perf_counter_ns`` by its device time from the anchor, within the anchor's
bound.  The anchor is taken at the first span or traced call after :func:`reset` and kept
until the next reset (entering :func:`tracing` again takes no new one), so that a caller
that turns the tracer on for every step does not pay a synchronization each time; the
two clocks drift apart slowly, so a long-lived tracer is reset to anchor anew.

:func:`report` returns the spans, the counters, each stage's seconds and count by graph,
the calls' anchored device intervals and the device's idle gaps between them, each named
by the innermost span open where it begins (``caller`` where none is), for everything
since :func:`reset`.  A replay's marks are read when the next replay of its graph starts
or when :func:`report` is called, whichever comes first.
"""

from __future__ import annotations

import bisect
import contextlib
import itertools
import threading
import time
from collections import defaultdict, deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

CALLER = "caller"  # an idle gap that no program span was open at
MAX_SPANS = 1 << 17
MAX_CALLS = 1 << 14
ANCHOR_TRIES = 5


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None
    step: int | None


class Interval(NamedTuple):
    """A graphed call on the device: its graph's name, ``kind`` (``replay``, ``eager``
    or ``capture``), its step id and its stages as (name, start_ns, end_ns) on the host's
    clock, in device order."""

    graph: str
    kind: str
    step: int | None
    stages: list

    @property
    def start_ns(self) -> int:
        return self.stages[0][1]

    @property
    def end_ns(self) -> int:
        return self.stages[-1][2]


class Report(NamedTuple):
    spans: list             # [Span], in the order they ended
    counters: dict          # name -> count
    stages: dict            # graph -> stage -> (seconds, count), replays and eager calls
    calls: dict             # graph -> replays and eager calls with marks
    intervals: list         # [Interval], by start
    idle: list              # [(span name or CALLER, start_ns, seconds)], by start
    idle_by_span: dict      # span name or CALLER -> idle seconds while it was innermost
    anchor_bound_s: float | None  # the widest bound of the anchors used
    dropped: int            # spans and calls that the bounded buffers let go


class _Call:
    """One graphed call's marks: [(stage name or None, CUDA event or host ns)]."""

    __slots__ = ("graph", "kind", "step", "marks", "cuda", "generation")

    def __init__(self, graph: str, step: int, generation: int):
        self.graph, self.step, self.generation = graph, step, generation
        self.kind, self.marks, self.cuda = "eager", [], None

    def open(self, kind: str, device) -> None:
        """The call is a ``kind`` (``replay``, ``eager`` or ``capture``) on ``device``:
        on a card its marks are events (``cuda`` holds the card's index)."""
        self.kind = kind
        if device.type == "cuda":
            self.cuda = torch.cuda.current_device() if device.index is None \
                else device.index

    def mark(self, name) -> None:
        if self.cuda is not None:
            event = torch.cuda.Event(enable_timing=True)
            event.record()
            self.marks.append((name, event))
        else:
            self.marks.append((name, time.perf_counter_ns()))


class _Local(threading.local):
    def __init__(self):
        self.spans = []      # open spans, innermost last
        self.calls = []      # open call records, innermost last
        self.sink = None     # the marks list of the graph being captured
        self.counts = None   # the counts list of the graph being captured


class Tracer:
    """What the tracer has kept since its last reset (one per process: ``TRACER``)."""

    def __init__(self):
        self.depth = 0                  # tracing() nesting
        self.local = _Local()
        self.ids = itertools.count(1)       # span ids
        self.sequence = itertools.count(1)  # graphed calls' sequence numbers
        self.generation = 0                 # of the calls kept, one per reset
        self.reset()

    def reset(self) -> None:
        self.generation += 1
        self.active = False             # anchored since the reset
        self.anchors = {}               # device index -> (event, host ns, bound ns)
        self.spans = deque(maxlen=MAX_SPANS)
        self.intervals = deque(maxlen=MAX_CALLS)
        self.counters = defaultdict(int)
        self.stages = defaultdict(lambda: defaultdict(lambda: [0.0, 0]))
        self.calls = defaultdict(int)
        self.pending = []               # call records whose CUDA events are unread
        self.tallies = {}               # (names, device, stream) -> unread counts
        self.seen = 0                   # spans and calls ever kept

    # -- turning on ----------------------------------------------------------------------

    def activate(self) -> None:
        self.active = True
        if torch.cuda.is_available() and torch.cuda.is_initialized() \
                and not torch.cuda.is_current_stream_capturing():
            self._anchor(torch.cuda.current_device())

    def _anchor(self, index: int):
        """Synchronize, then record an event between two host clock reads: its device
        time lies between them."""
        best = None
        with torch.cuda.device(index):
            torch.cuda.synchronize()
            for _ in range(ANCHOR_TRIES):
                event = torch.cuda.Event(enable_timing=True)
                before = time.perf_counter_ns()
                event.record()
                while not event.query():
                    pass
                after = time.perf_counter_ns()
                if best is None or after - before < best[2]:
                    best = (event, (before + after) // 2, after - before)
        self.anchors[index] = best
        return best

    # -- call records --------------------------------------------------------------------

    def collect(self, call: _Call) -> None:
        """Read a call's marks into the intervals and the stages' sums (a call of an
        earlier generation, from before a reset, is dropped)."""
        if call in self.pending:
            self.pending.remove(call)
        if call.generation != self.generation or not call.marks:
            return
        call.generation = None  # read once
        if call.cuda is not None:
            times = self._device_times(call.cuda, [m for _, m in call.marks])
        else:
            times = [m for _, m in call.marks]
        stages = [(name, times[i], times[i + 1]) for i, (name, _) in
                  enumerate(call.marks[:-1]) if name is not None]
        if not stages:
            return
        self.seen += 1
        self.intervals.append(Interval(call.graph, call.kind, call.step, stages))
        if call.kind == "capture":
            return
        sums = self.stages[call.graph]
        for name, start, end in stages:
            entry = sums[name]
            entry[0] += (end - start) * 1e-9
            entry[1] += 1
        self.calls[call.graph] += 1

    def _device_times(self, index: int, events) -> list:
        """Host ns of each event: the first by the anchor, the rest by their distance
        from the first (which keeps a call's stages at the events' own resolution)."""
        events[-1].synchronize()
        anchor = self.anchors.get(index) or self._anchor(index)
        first = events[0]
        base = anchor[1] + anchor[0].elapsed_time(first) * 1e6
        return [base] + [base + first.elapsed_time(e) * 1e6 for e in events[1:]]

    def settle(self) -> None:
        for call in list(self.pending):
            self.collect(call)
        for (names, device, _), tally in self.tallies.items():
            if device.type == "cuda":
                torch.cuda.synchronize(device)  # whichever stream added to it
            for name, n in zip(names, tally.tolist()):
                self.counters[name] += n
        self.tallies.clear()

    # -- the report ----------------------------------------------------------------------

    def report(self) -> Report:
        self.settle()
        intervals = sorted(self.intervals, key=lambda i: i.start_ns)
        spans = list(self.spans)
        busy = _merge([(s, e) for i in intervals for _, s, e in i.stages])
        gaps = [(end, start) for (_, end), (start, _) in zip(busy, busy[1:])]
        name_at, cuts = _innermost(spans)
        idle = [(name_at(begin), begin, (end - begin) * 1e-9) for begin, end in gaps]
        by_span = defaultdict(float)
        for begin, end in gaps:
            points = [begin] + cuts(begin, end) + [end]
            for a, b in zip(points, points[1:]):
                by_span[name_at(a)] += (b - a) * 1e-9
        bounds = [a[2] for a in self.anchors.values()]
        return Report(spans, dict(self.counters),
                      {g: {s: (v[0], v[1]) for s, v in st.items()}
                       for g, st in self.stages.items()},
                      dict(self.calls), intervals, idle, dict(by_span),
                      max(bounds) * 1e-9 if bounds else None,
                      self.seen - len(spans) - len(self.intervals))


def _merge(intervals) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def _innermost(spans):
    """(at -> the name of the innermost span open at host time ``at``, else CALLER: the
    latest-starting span around it, found among those that started at most the longest
    span's duration before it; (begin, end) -> the sorted starts and ends of spans
    strictly inside (begin, end), where the innermost span can change)."""
    spans = sorted(spans, key=lambda s: s.start_ns)
    starts = [s.start_ns for s in spans]
    longest = max((s.end_ns - s.start_ns for s in spans), default=0)

    def name_at(at) -> str:
        i = bisect.bisect_right(starts, at) - 1
        while i >= 0 and starts[i] >= at - longest:
            if spans[i].end_ns > at:
                return spans[i].name
            i -= 1
        return CALLER

    def cuts(begin, end) -> list:
        lo = bisect.bisect_left(starts, begin - longest)
        hi = bisect.bisect_right(starts, end)
        inside = {t for s in spans[lo:hi] for t in (s.start_ns, s.end_ns)
                  if begin < t < end}
        return sorted(inside)

    return name_at, cuts


TRACER = Tracer()


def enabled() -> bool:
    """True inside :func:`tracing` or while a torch profiler runs."""
    return TRACER.depth > 0 or _profiler._is_profiler_enabled


@contextlib.contextmanager
def tracing():
    """Turn the tracer on inside the block (nests)."""
    TRACER.depth += 1
    try:
        yield TRACER
    finally:
        TRACER.depth -= 1


def reset() -> None:
    """Forget everything kept so far."""
    TRACER.reset()


def report() -> Report:
    """What the tracer kept since :func:`reset` (see the module docstring)."""
    return TRACER.report()


def stage_seconds() -> dict:
    """graph -> stage -> [seconds, count] so far (a copy), every call's marks read."""
    TRACER.settle()
    return {g: {s: list(v) for s, v in st.items()} for g, st in TRACER.stages.items()}


def count(name: str, n: int = 1) -> None:
    """Add n to counter ``name``: into the graph being captured (each replay adds it),
    else at once while the tracer is on."""
    counts = TRACER.local.counts
    if counts is not None:
        counts.append((name, n))
    elif TRACER.depth > 0 or _profiler._is_profiler_enabled:
        TRACER.counters[name] += n


def device_tally(names: tuple, device) -> torch.Tensor | None:
    """Counters ``names`` for a kernel to add to on the card: None unless the tracer is
    on and no capture runs; else a zeroed int64 tensor of len(names) on ``device``, the
    same one for every call on the current stream until the report reads it into the
    counters.  Only the report waits for the card; the calls do not."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    if TRACER.local.counts is not None or not enabled() or (
            cuda and torch.cuda.is_current_stream_capturing()):
        return None
    key = (tuple(names), device, torch.cuda.current_stream(device) if cuda else None)
    tally = TRACER.tallies.get(key)
    if tally is None:
        tally = TRACER.tallies[key] = torch.zeros(len(names), dtype=torch.int64,
                                                  device=device)
    return tally


class _Span:
    """A timed span: kept by the tracer when ``keep``, a profiler range when
    ``ranges``.  ``seconds`` holds its duration after the block."""

    __slots__ = ("name", "step", "keep", "ranges", "range", "id", "parent", "start",
                 "seconds")

    def __init__(self, name: str, step=None, keep: bool = True, ranges: bool = False):
        self.name, self.step, self.keep, self.ranges = name, step, keep, ranges
        self.range = None

    def __enter__(self):
        if self.keep:
            tracer, local = TRACER, TRACER.local
            if not tracer.active:
                tracer.activate()
            self.id = next(tracer.ids)
            outer = local.spans[-1] if local.spans else None
            self.parent = outer.id if outer is not None else None
            if self.step is None:
                if outer is not None:
                    self.step = outer.step
                elif local.calls:
                    self.step = local.calls[-1].step
            local.spans.append(self)
        if self.ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.seconds = (end - self.start) * 1e-9
        if self.range is not None:
            self.range.__exit__(*exc)
        if self.keep:
            TRACER.local.spans.pop()
            TRACER.spans.append(Span(self.id, self.name, self.start, end, self.parent,
                                     self.step))
            TRACER.seen += 1
        return False


_NULL = contextlib.nullcontext()


def span(name: str, step: int | None = None):
    """A host span named ``name`` (``step``: its step id, which the spans inside it
    take); the shared null context while the tracer is off."""
    if not (TRACER.depth > 0 or _profiler._is_profiler_enabled):
        return _NULL
    return _Span(name, step, True, _profiler._is_profiler_enabled)


class _CallScope:
    __slots__ = ("graph", "call")

    def __init__(self, graph: str):
        self.graph = graph

    def __enter__(self) -> _Call:
        tracer = TRACER
        if not tracer.active:
            tracer.activate()
        self.call = _Call(self.graph, next(tracer.sequence), tracer.generation)
        tracer.local.calls.append(self.call)
        return self.call

    def __exit__(self, exc_type, *_):
        TRACER.local.calls.pop()
        if exc_type is None and self.call.marks:
            if self.call.cuda is not None:
                TRACER.pending.append(self.call)
            else:
                TRACER.collect(self.call)
        return False


def call(graph: str):
    """The record of one graphed call of ``graph`` (its marks are read when it ends on
    the CPU, later on the card); the null context, giving None, while the tracer is
    off."""
    if not (TRACER.depth > 0 or _profiler._is_profiler_enabled):
        return _NULL
    return _CallScope(graph)


def stage(name: str | None) -> None:
    """Mark the start of stage ``name`` (None: the end of the open stage) on the current
    stream: into the graph being captured, else into the open call while the tracer is
    on (see the module docstring)."""
    local = TRACER.local
    if local.sink is not None:
        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record()
        local.sink.append((name, event))
        return
    if not (TRACER.depth > 0 or _profiler._is_profiler_enabled) or not local.calls:
        return
    local.calls[-1].mark(name)


@contextlib.contextmanager
def capturing(marks: list, counts: list):
    """Inside the block, marks go into ``marks`` and counts into ``counts``: a graph's
    capture."""
    local = TRACER.local
    saved = local.sink, local.counts
    local.sink, local.counts = marks, counts
    try:
        yield
    finally:
        local.sink, local.counts = saved


class ExecutionTimer:
    """Accumulates per-phase durations: correspondences, gradient_and_hessian,
    optimization, results, complete_cycle.  Its spans are the tracer's (kept by it while
    it is on); with ``use_profiler_ranges`` each is a ``torch.profiler`` range
    whatever the tracer's state."""

    def __init__(self, use_profiler_ranges: bool = False):
        self.use_profiler_ranges = use_profiler_ranges
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        timed = _Span(name, None, enabled(),
                      self.use_profiler_ranges or _profiler._is_profiler_enabled)
        with timed:
            yield
        self.totals[name] += timed.seconds
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
