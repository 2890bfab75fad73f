"""The Tracker's and the fused serve backend's spans (utils/timing.py), and the
evaluators' fused step's phase times read off the cycle's stage marks, on the CPU, on
tests/test_torch_serve.py's graph: with the tracer off a step keeps nothing, enters no
profiler range and makes no event; with it on, a step opens the object graph's spans,
numbered by the iteration."""

import pytest

from m3t_tpu_torch.eval import metrics
from m3t_tpu_torch.utils import timing
from tests.test_torch_serve import _graph, _step, world  # noqa: F401 (fixture)
from tests.test_torch_timing import _Counting, _kept_nothing


@pytest.fixture(autouse=True)
def fresh_tracer():
    timing.reset()
    yield
    timing.reset()


def _tracker(world, prefix, fused):
    """A Tracker of tests/test_torch_serve.py's graph, detected and started."""
    tracker, _ = _graph(world, "torch", prefix, fused)
    _step(tracker, 0)
    return tracker, _step


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_off_a_tracker_step_keeps_nothing(world, fused, monkeypatch):
    tracker, step = _tracker(world, f"off{int(fused)}", fused)
    timing.reset()
    counting = _Counting(monkeypatch)
    step(tracker, 1)
    assert _kept_nothing() and not counting.made


@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_a_tracker_step_opens_its_spans(world, fused):
    tracker, step = _tracker(world, f"on{int(fused)}", fused)
    with timing.tracing():
        step(tracker, 1)
    spans = timing.report().spans
    by_name = {s.name: s for s in spans}
    want = {"tracker.update_cameras", "tracker.update_subscribers",
            "tracker.consistent_poses", "tracker.detecting_step", "tracker.starting_step",
            "tracker.tracking_step"}
    want |= ({"serve.gather", "serve.frames", "serve.cycle", "serve.scatter",
              "graphs.key"} if fused else
             {"tracker.correspondences", "tracker.gradient_hessian",
              "tracker.optimization", "tracker.results"})
    assert want <= set(by_name)
    step_span = by_name["tracker.tracking_step"]
    inside = [s for s in spans if s.parent == step_span.id]
    assert inside and all(s.step == 1 for s in inside)


def test_fused_phase_times_come_from_the_stages(world):
    tracker, _ = _tracker(world, "phases", True)
    assert tracker.UpdateCameras(1)
    times = metrics.execute_tracking_step_maybe_fused(tracker, 1)
    phases = ("calculate_correspondences", "calculate_gradient_and_hessian",
              "calculate_optimization", "calculate_results")
    assert times["fused"] is True
    assert all(times[p] > 0.0 for p in phases)
    assert sum(times[p] for p in phases) <= times["complete_cycle"]
    assert not timing.enabled()
