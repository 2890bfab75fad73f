"""The port's tracer (m3t_tpu_torch/utils/timing.py) and its marks in the graphs, the
cycles, the Tracker and the fused serve backend.

On the CPU: with the tracer off a graphed call and a Tracker step keep nothing, enter no
profiler range and make no event; spans nest and carry step ids; a torch profiler turns
the tracer on and off; the stage marks tile the region cycle at 5 x 2 iterations, the
RGB-D and the articulated cycle (marks are host timestamps there); the copies into a
graph's static buffers are counted by hand; idle gaps are named by the span open where
they begin.  tests/test_torch_serve_spans.py holds the Tracker's spans.

The tests marked ``cuda`` need a card and skip without one: the cycles' stages tile a
replay on the device's clock, collecting after replays gives every stage of each
replay, and the tracer leaves a graph's outputs bit for bit as they are.  The machine
with the card has no JAX, so run them there as

    python -m pytest --noconftest -q tests/test_torch_timing.py -m cuda
"""

import time
from collections import Counter

import numpy as np
import pytest
import torch

from m3t_tpu_torch import graphs, pipeline
from m3t_tpu_torch.parallel import dryrun
from m3t_tpu_torch.utils import timing

CYCLES = ("region", "rgbd", "kinematic")


@pytest.fixture(autouse=True)
def fresh_tracer():
    timing.reset()
    yield
    timing.reset()


def _calls(inp) -> dict:
    """name -> (graphed cycle, args, kwargs): the region cycle at 5 x 2 iterations with
    both region scene checks; the RGB-D cycle with every scene check, measured
    occlusions and texture terms; the articulated RGB-D cycle with per-link scenes (the
    dry run's problem, first camera, as tests/test_torch_graphs.py takes it)."""
    from m3t_tpu_torch.ops.texture_fn import TexturePoints

    pcfg, intr, dev = inp["pcfg"], inp["intr"], inp["poses"].device
    images, depth = inp["images"][:, 0], inp["depth_images"][:, 0]
    b = images.shape[0]
    state = pipeline.initialize_histograms(pcfg, intr, images, inp["model"], inp["poses"])
    rng = np.random.default_rng(5)
    texture = TexturePoints(*(torch.as_tensor(a, device=dev) for a in (
        rng.normal(0.0, 0.03, (b, 16, 3)).astype(np.float32),
        rng.uniform(60.0, 100.0, (b, 16, 2)).astype(np.float32),
        rng.random((b, 16)) > 0.4)))
    scene = dict(scene_geom=inp["scene_geom"], occluder_poses=inp["occluder_poses"])
    kin_images = inp["kin_images"][:, 0]
    kin_state = pipeline.initialize_kinematic_histograms(
        pcfg, intr, kin_images, inp["link_model"], inp["kin"], inp["joint2parent"])
    return {
        "region": (pipeline.tracking_cycle,
                   (pcfg._replace(use_depth=False, n_corr_iterations=5,
                                  n_update_iterations=2), intr, images, inp["model"],
                    state), scene),
        "rgbd": (pipeline.tracking_cycle_rgbd,
                 (pcfg._replace(use_texture=True), intr, intr, dryrun.DEPTH_SCALE, images,
                  depth, inp["model"], inp["depth_model"], state),
                 dict(scene, texture_points=texture)),
        "kinematic": (pipeline.tracking_cycle_kinematic,
                      (pcfg, intr, kin_images, inp["link_model"], inp["kin"], kin_state),
                      dict(scene_geom=inp["kin_scene"], depth_intr=intr,
                           depth_scale=dryrun.DEPTH_SCALE,
                           depth_images=inp["kin_depth"][:, 0],
                           depth_model=inp["link_depth_model"])),
    }


def _expected_stages(name: str, pcfg) -> list:
    """The stages a cycle's marks give, in order: the graph's own start, the cycle's
    prologue (the RGB-D cycles' depth crop corners), per correspondence iteration the
    scene, the view, the region lines (their measured-occlusion windows from the depth
    frames first) and the depth terms (the points' measured-occlusion windows inside),
    per update iteration the gradient terms and the Newton step (the articulated
    cycle's KKT step in its two stages), then the histograms."""
    rgbd, kinematic = name == "rgbd", name == "kinematic"
    depth = pcfg.use_depth and (rgbd or kinematic)
    stages = ["graphs.run"] + ["depth_correspondences"] * depth + ["crops"]
    for _ in range(pcfg.n_corr_iterations):
        stages += ["scene_render", "view"]
        if rgbd and pcfg.region_measure_occlusions and depth:
            stages.append("measured_occlusion")
        stages += ["line_geometry", "sample_lines", "lines"]
        stages += ["depth_correspondences"] * depth
        if depth and pcfg.depth_measure_occlusions:
            stages += ["measured_occlusion", "depth_correspondences"]
        for _ in range(pcfg.n_update_iterations):
            stages.append("gradient_hessian")
            stages += ["depth_gradient_hessian"] * depth
            stages += ["texture_gradient_hessian"] * (rgbd and pcfg.use_texture)
            stages.append("newton_step")
            stages += ["kinematic_terms", "kkt_solve"] * kinematic
    return stages + ["histogram_walk", "histogram_count", "histogram_blend"]


@pytest.fixture(scope="module")
def cpu_calls():
    return _calls(dryrun.problem(torch.device("cpu"), 1))


class _Counting:
    """Stand-ins for torch.cuda.Event and torch.profiler.record_function that count
    their instances."""

    def __init__(self, monkeypatch):
        self.made = Counter()
        event, record_function = torch.cuda.Event, torch.profiler.record_function

        def counted(name, cls):
            def make(*args, **kwargs):
                self.made[name] += 1
                return cls(*args, **kwargs)
            return make

        monkeypatch.setattr(torch.cuda, "Event", counted("event", event))
        monkeypatch.setattr(torch.profiler, "record_function",
                            counted("range", record_function))
        monkeypatch.setattr(torch.autograd.profiler, "record_function",
                            counted("range", record_function))


def _kept_nothing():
    tracer = timing.TRACER
    return (not tracer.spans and not tracer.intervals and not tracer.counters
            and not tracer.pending and not tracer.calls)


# ---------------------------------------------------------------------------------------
# The tracer
# ---------------------------------------------------------------------------------------


def test_off_a_graphed_cycle_keeps_nothing(cpu_calls, monkeypatch):
    counting = _Counting(monkeypatch)
    fn, args, kwargs = cpu_calls["rgbd"]
    assert not timing.enabled()
    fn(*args, **kwargs)
    with graphs.disable_graphs():
        fn(*args, **kwargs)
    assert _kept_nothing() and not counting.made
    assert timing.span("graphs.key") is timing.span("tracker.tracking_step")


def test_nested_spans_carry_parent_and_step():
    with timing.tracing():
        with timing.span("outer", step=7):
            with timing.span("inner"):
                with timing.span("innermost"):
                    pass
            with timing.span("sibling", step=8):
                pass
        with timing.span("alone"):
            pass
    spans = {s.name: s for s in timing.report().spans}
    assert spans["outer"].parent is None and spans["alone"].parent is None
    assert spans["inner"].parent == spans["outer"].id
    assert spans["innermost"].parent == spans["inner"].id
    assert spans["sibling"].parent == spans["outer"].id
    assert [spans[n].step for n in ("outer", "inner", "innermost", "sibling", "alone")] \
        == [7, 7, 7, 8, None]
    assert spans["outer"].start_ns <= spans["inner"].start_ns <= spans["inner"].end_ns \
        <= spans["sibling"].start_ns <= spans["outer"].end_ns


def test_the_tracer_turns_on_once_until_a_reset(monkeypatch):
    """The anchor (a synchronization on a card) is taken once: entering tracing() again,
    as an evaluator does for every step, keeps it; a reset lets it go."""
    activate, turned_on = timing.TRACER.activate, []

    def counted():
        turned_on.append(True)
        activate()

    monkeypatch.setattr(timing.TRACER, "activate", counted)
    for _ in range(3):
        with timing.tracing(), timing.span("step"):
            pass
    assert len(turned_on) == 1
    timing.reset()
    with timing.tracing(), timing.span("step"):
        pass
    assert len(turned_on) == 2


def test_a_graphed_call_numbers_its_spans(cpu_calls):
    fn, args, kwargs = cpu_calls["kinematic"]
    with timing.tracing():
        fn(*args, **kwargs)
        fn(*args, **kwargs)
    report = timing.report()
    keys = [s for s in report.spans if s.name == "graphs.key"]
    steps = [i.step for i in report.intervals]
    assert len(keys) == 2 and [s.step for s in keys] == steps and steps[0] < steps[1]
    assert report.calls == {"tracking_cycle_kinematic": 2}


def test_a_profiler_turns_the_tracer_on_and_off():
    assert not timing.enabled()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        assert timing.enabled()
        with timing.span("traced"):
            torch.ones(4).sum()
        timing.count("things", 3)
    assert not timing.enabled()
    with timing.span("untraced"):
        timing.count("things", 5)
    report = timing.report()
    assert [s.name for s in report.spans] == ["traced"]
    assert report.counters == {"things": 3}
    assert "traced" in [e.key for e in prof.key_averages()]


def test_execution_timer_spans_are_the_tracers():
    timer = timing.ExecutionTimer()
    with timer.span("calculate_results"):
        pass
    with timing.tracing():
        with timer.span("complete_cycle"):
            with timer.span("calculate_results"):
                pass
    spans = timing.report().spans
    assert [s.name for s in spans] == ["calculate_results", "complete_cycle"]
    assert spans[0].parent == spans[1].id
    assert timer.counts["calculate_results"] == 2 and timer.counts["complete_cycle"] == 1


@graphs.graphed()
def _two_stages(x):
    timing.stage("first")
    y = x + 1.0
    timing.stage("second")
    return y * 2.0


def test_idle_gaps_are_named_by_the_open_span():
    x = torch.ones(8)
    with timing.tracing():
        with timing.span("between"):
            _two_stages(x)
            time.sleep(0.002)
        _two_stages(x)
        time.sleep(0.002)
        with timing.span("later"):
            time.sleep(0.001)
            _two_stages(x)
    report = timing.report()
    assert [i.graph for i in report.intervals] == ["_two_stages"] * 3
    assert [[s for s, _, _ in i.stages] for i in report.intervals] == \
        [["graphs.run", "first", "second"]] * 3
    assert [name for name, _, _ in report.idle] == ["between", timing.CALLER]
    assert all(seconds >= 0.002 for _, _, seconds in report.idle)
    by_span = report.idle_by_span
    assert by_span["between"] >= 0.002 and by_span["later"] >= 0.001
    assert by_span[timing.CALLER] >= 0.002 and by_span["graphs.key"] > 0
    assert sum(by_span.values()) == pytest.approx(sum(s for _, _, s in report.idle))
    first = report.intervals[0]
    assert all(a[2] == b[1] for a, b in zip(first.stages, first.stages[1:]))
    seconds, count = report.stages["_two_stages"]["first"]
    assert count == 3 and seconds > 0
    assert report.anchor_bound_s is None and report.dropped == 0


def test_reset_forgets_what_was_kept():
    with timing.tracing():
        _two_stages(torch.ones(2))
        timing.count("graphs.copy_bytes", 4)
    timing.reset()
    report = timing.report()
    assert not report.spans and not report.intervals and not report.counters


def test_a_device_tally_counts_when_the_report_reads_it():
    """A device tally exists only with the tracer on and no capture running; the calls
    until the report share one tally, the report adds it to the counters and forgets
    it, and a reset drops an unread tally."""
    names = ("a.rows", "a.kept")
    assert timing.device_tally(names, "cpu") is None
    with timing.tracing():
        first = timing.device_tally(names, "cpu")
        assert timing.device_tally(names, "cpu") is first
        first += torch.tensor([5, 2])
        with timing.capturing([], []):
            assert timing.device_tally(names, "cpu") is None
        assert timing.report().counters == {"a.rows": 5, "a.kept": 2}
        second = timing.device_tally(names, "cpu")
        assert second is not first and second.tolist() == [0, 0]
        second += torch.tensor([1, 1])
        assert timing.report().counters == {"a.rows": 6, "a.kept": 3}
        timing.device_tally(names, "cpu").add_(7)
    timing.reset()
    assert timing.report().counters == {}


@pytest.mark.parametrize("name", CYCLES)
def test_stages_tile_the_cycle(cpu_calls, name):
    """The marks give the expected stages, in order and back to back, from the graph's
    start to the cycle's end, and the report sums them by graph."""
    fn, args, kwargs = cpu_calls[name]
    with timing.tracing():
        begin = time.perf_counter_ns()
        fn(*args, **kwargs)
        end = time.perf_counter_ns()
    report = timing.report()
    (interval,) = report.intervals
    stages = interval.stages
    assert [s for s, _, _ in stages] == _expected_stages(name, args[0])
    assert all(a[2] == b[1] for a, b in zip(stages, stages[1:]))
    assert begin <= interval.start_ns <= interval.end_ns <= end
    graph = fn.__wrapped__.__qualname__
    assert report.calls == {graph: 1}
    assert {s: n for s, (_, n) in report.stages[graph].items()} == \
        dict(Counter(_expected_stages(name, args[0])))
    assert sum(s for s, _ in report.stages[graph].values()) == pytest.approx(
        (interval.end_ns - interval.start_ns) * 1e-9, rel=1e-9)
    assert set(report.stages[graph]) - {"graphs.run"} <= set(pipeline.STAGE_PHASES)


def test_copy_bytes_count_an_expanded_and_a_plain_argument():
    frame = torch.zeros((1, 3, 5, 7), dtype=torch.uint8).expand(4, 3, 5, 7)
    state = torch.zeros((4, 6), dtype=torch.float64)
    entry = graphs._Graph("hand", [frame, state])
    with timing.tracing():
        entry.load([frame, state])
        assert timing.report().counters == {"graphs.copy_bytes": 3 * 5 * 7 + 4 * 6 * 8}
        entry.load([frame, state])  # both unchanged: nothing copied
        assert timing.report().counters == {"graphs.copy_bytes": 3 * 5 * 7 + 4 * 6 * 8}
        state.add_(1.0)
        entry.load([frame, state])
    counters = timing.report().counters
    assert counters == {"graphs.copy_bytes": 3 * 5 * 7 + 2 * 4 * 6 * 8}


# ---------------------------------------------------------------------------------------
# On the card (marker "cuda")
# ---------------------------------------------------------------------------------------


@pytest.fixture
def cuda_calls():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    graphs.clear_graphs()
    yield _calls(dryrun.problem(torch.device("cuda"), 1))
    graphs.clear_graphs()


def _replays(fn, args, kwargs, n: int) -> list:
    """A capture, then n replays, each from the state the last one gave."""
    at = 5 if fn is pipeline.tracking_cycle_kinematic else (
        8 if fn is pipeline.tracking_cycle_rgbd else 4)
    args, states = list(args), []
    for _ in range(n + 1):
        states.append(fn(*args, **kwargs))
        args[at] = states[-1]
    torch.cuda.synchronize()
    return states


@pytest.mark.cuda
@pytest.mark.parametrize("name", CYCLES)
def test_stages_tile_a_replay_on_card(cuda_calls, name):
    """Per replay: the copies, the cycle's expected stages and the clones, each stage of
    positive length, back to back within the graph; the whole within 1 % of the replay's
    outer interval (what lies outside a stage is the graph's launch)."""
    fn, args, kwargs = cuda_calls[name]
    _replays(fn, args, kwargs, 1)
    with timing.tracing():
        _replays(fn, args, kwargs, 0)  # replays: the graph was captured above
        _replays(fn, args, kwargs, 0)
    report = timing.report()
    graph = fn.__wrapped__.__qualname__
    assert report.calls == {graph: 2}
    for interval in report.intervals:
        names = [s for s, _, _ in interval.stages]
        assert names == ["graphs.copy"] + _expected_stages(name, args[0]) + \
            ["graphs.clone"]
        inner = interval.stages[1:-1]
        assert all(a[2] == b[1] for a, b in zip(inner, inner[1:]))
        assert all(e > s for _, s, e in inner)
        total = sum(e - s for _, s, e in interval.stages)
        assert total <= interval.end_ns - interval.start_ns
    assert report.anchor_bound_s is not None and report.anchor_bound_s < 1e-3


@pytest.mark.cuda
def test_collecting_gives_every_stage_of_each_replay(cuda_calls):
    fn, args, kwargs = cuda_calls["region"]
    _replays(fn, args, kwargs, 1)
    want = Counter(_expected_stages("region", args[0]) + ["graphs.copy", "graphs.clone"])
    with timing.tracing():
        _replays(fn, args, kwargs, 0)
        _replays(fn, args, kwargs, 0)
        _replays(fn, args, kwargs, 0)
    graphs.clear_graphs()  # leaves what the tracer holds
    stages = timing.report().stages["tracking_cycle"]
    assert {s: n for s, (_, n) in stages.items()} == {s: 3 * n for s, n in want.items()}
    assert all(seconds > 0 for seconds, _ in stages.values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CYCLES)
def test_the_tracer_leaves_graph_outputs_as_they_are(cuda_calls, name):
    fn, args, kwargs = cuda_calls[name]
    untraced = _replays(fn, args, kwargs, 2)
    with timing.tracing():
        traced = _replays(fn, args, kwargs, 2)
    with graphs.disable_graphs():
        eager = _replays(fn, args, kwargs, 2)
    for a, b, c in zip(untraced, traced, eager):
        for x, y, z in zip(a, b, c):
            assert torch.equal(x, y) and torch.equal(x, z)


@pytest.mark.cuda
def test_kinematic_counters_count_every_replay(cuda_calls):
    """The articulated cycle's counters (taken into its graph at the capture) count the
    first call and each replay: S structures, S * NL links, S * (NL + NC) * 6 KKT rows,
    and per correspondence iteration B * T scene triangles and the B * P depth points'
    measured-occlusion windows (the dry run's problem checks them).  K4's block-cull
    counters come from a tally on the card that eager launches add to and the report
    reads: the first call's eager run counts them as the same cycle run eagerly does,
    and the capture and the replays add nothing."""
    from m3t_tpu_torch.ops import kinematics as kin_ops

    fn, args, kwargs = cuda_calls["kinematic"]
    pcfg, kin = args[0], args[4]
    s, nl = kin.parent.shape
    b, t = kwargs["scene_geom"].tri_valid.shape
    assert pcfg.depth_measure_occlusions
    points = kwargs["depth_model"].centers.shape[2]
    with graphs.disable_graphs(), timing.tracing():
        fn(*args, **kwargs)
    rows = {name: timing.report().counters[name]
            for name in ("occlusion.query_rows_scanned", "occlusion.query_rows_kept")}
    assert 0 < rows["occlusion.query_rows_kept"] <= rows["occlusion.query_rows_scanned"]
    timing.reset()
    with timing.tracing():
        _replays(fn, args, kwargs, 2)
    assert timing.report().counters == {
        "graphs.copy_bytes": timing.report().counters["graphs.copy_bytes"],
        "kinematics.structures": 3 * s, "kinematics.links": 3 * s * nl,
        "kinematics.kkt_rows": 3 * s * kin_ops.kkt_rows(kin),
        "occlusion.scene_triangles": 3 * pcfg.n_corr_iterations * b * t,
        "depth.occlusion_windows": 3 * pcfg.n_corr_iterations * b * points, **rows}
