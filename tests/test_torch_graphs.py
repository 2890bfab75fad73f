"""The port's counterpart of jax.jit: m3t_tpu_torch/graphs.py and the graphed cycles.

On the CPU: the static key separates what must be separate and equates what must be
equal (also for the two multi-camera cycles, keyed on what they were built from, and
for numpy camera values, which run as the same numbers do), the
static buffers keep an argument's expanded dimensions, disable_graphs nests, a
collective runs in place outside a capture, the decorated cycles run eagerly and capture
nothing, and no cycle reads a value back on the host (which a capture on the card
forbids).  The inputs are those of the scale-out dry run
(m3t_tpu_torch.parallel.dryrun.problem: two bodies or two-link structures at 160x128,
64 lines and points, 2x2 iterations, every scene check; the multi-camera cycles with
both of its cameras and mesh=None).

The tests marked ``cuda`` need a card and skip without one: graph equal to eager bit for
bit for the three cycles and the two multi-camera cycles, numpy camera values, fresh
outputs, launch counts
per replay, a capture that fails raising, and a function split into two segments by a
collective.  The machine with the card has no JAX, so run them there as

    python -m pytest --noconftest -q tests/test_torch_graphs.py
"""

import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from m3t_tpu_torch import graphs, parallel, pipeline
from m3t_tpu_torch.ops import _cuda, depth_fast, newton, occlusion, region_fast
from m3t_tpu_torch.ops.texture_fn import TexturePoints
from m3t_tpu_torch.parallel import dryrun

import torch_host_reads  # tests/torch_host_reads.py: pytest puts tests/ on sys.path

CYCLES = ("region", "rgbd", "kinematic")
SHARDED = ("sharded", "sharded_kinematic")  # the multi-camera cycles, mesh=None


def _calls(inp) -> dict:
    """name -> (graphed cycle, args, kwargs) of the three cycles on a dry-run problem's
    first camera: the region cycle with both region scene checks and a per-body
    handle_occlusions; the RGB-D cycle with every scene check, measured occlusions,
    texture terms, pose groups and per-body depth budgets; the articulated RGB-D cycle
    with per-link scenes."""
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
    jp = inp["joint2parent"]
    kin_images = inp["kin_images"][:, 0]
    kin_state = pipeline.initialize_kinematic_histograms(pcfg, intr, kin_images,
                                                         inp["link_model"], inp["kin"], jp)
    return {
        "region": (pipeline.tracking_cycle,
                   (pcfg._replace(use_depth=False), intr, images, inp["model"], state),
                   dict(scene, handle_occlusions=torch.tensor([True, False], device=dev))),
        "rgbd": (pipeline.tracking_cycle_rgbd,
                 (pcfg._replace(use_texture=True), intr, intr, dryrun.DEPTH_SCALE, images,
                  depth, inp["model"], inp["depth_model"], state),
                 dict(scene, texture_points=texture,
                      pose_group=torch.arange(b, device=dev, dtype=torch.int32),
                      depth_n_points=torch.tensor([dryrun.N_POINTS, 0], device=dev))),
        "kinematic": (pipeline.tracking_cycle_kinematic,
                      (pcfg, intr, kin_images, inp["link_model"], inp["kin"], kin_state),
                      dict(scene_geom=inp["kin_scene"], depth_intr=intr,
                           depth_scale=dryrun.DEPTH_SCALE,
                           depth_images=inp["kin_depth"][:, 0],
                           depth_model=inp["link_depth_model"])),
        # The multi-camera cycles of the dry run with mesh=None, both cameras, per-body
        # (per-link) handle_occlusions.
        "sharded": _sharded_call(dryrun.rigid_call(inp, None),
                                 torch.tensor([True, False], device=dev)),
        "sharded_kinematic": _sharded_call(
            dryrun.kinematic_call(inp, None),
            torch.tensor([[True, False], [True, True]], device=dev)),
    }


def _sharded_call(call, handle):
    return call.cycle, call.args, dict(handle_occlusions=handle)


@pytest.fixture(scope="module")
def cpu_problem():
    return dryrun.problem(torch.device("cpu"), 1)


@pytest.fixture(scope="module")
def cpu_calls(cpu_problem):
    return _calls(cpu_problem)


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _changed(call, change):
    """The call's (args, kwargs) after change(args list, kwargs dict), the call's own
    unchanged."""
    _, args, kwargs = call
    args, kwargs = list(args), dict(kwargs)
    if change is not None:
        change(args, kwargs)
    return args, kwargs


def _set(index, fn):
    def change(args, kwargs):
        args[index] = fn(args[index])
    return change


def _set_kw(name, value):
    def change(args, kwargs):
        kwargs[name] = value
    return change


def _expanded_frame(contiguous: bool):
    def change(args, kwargs):
        frame = args[4][:1].expand(args[4].shape)
        args[4] = frame.contiguous() if contiguous else frame
    return change


# case -> (a change of the RGB-D call or None, a change of it): the two calls' keys must
# differ (SEPARATE) or be equal (EQUAL).
SEPARATE = {
    "pcfg field": (None, _set(0, lambda pcfg: pcfg._replace(n_update_iterations=1))),
    "intrinsic value": (None, _set(1, lambda intr: (intr[0] + 1.0,) + tuple(intr[1:]))),
    "depth scale value": (None, _set(3, lambda scale: scale * 1.1)),
    "None against a tensor": (None, _set_kw("texture_points", None)),
    "bool against a tensor handle_occlusions": (
        _set_kw("handle_occlusions", torch.tensor([True, True])),
        _set_kw("handle_occlusions", True)),
    "shape": (None, _set(5, lambda depth: depth[:, :-8].contiguous())),
    "dtype": (None, _set(8, lambda state: state._replace(
        body2camera_pose=state.body2camera_pose.double()))),
    "expanded frame against a contiguous one": (_expanded_frame(True),
                                                _expanded_frame(False)),
}

EQUAL = {
    "other tensor values": (None, _set(4, lambda images: torch.randint_like(images, 0, 255))),
    "another tensor of equal shape and strides": (None, _set(
        8, lambda state: pipeline.TrackingState(*(a.clone() for a in state)))),
    "another tuple of equal intrinsics": (None, _set(
        2, lambda intr: tuple(float(x) for x in intr))),
    "the model expanded again": (None, _set(6, lambda model: model._replace(
        orientations=model.orientations[:1].expand(model.orientations.shape)))),
}


def _keys(calls, changes):
    fn = calls["rgbd"][0]
    return [graphs.static_key(fn, *args, **kwargs)
            for args, kwargs in (_changed(calls["rgbd"], change) for change in changes)]


@pytest.mark.parametrize("case", sorted(SEPARATE))
def test_static_key_separates(cpu_calls, case):
    first, second = _keys(cpu_calls, SEPARATE[case])
    assert first != second


@pytest.mark.parametrize("case", sorted(EQUAL))
def test_static_key_equates(cpu_calls, case):
    first, second = _keys(cpu_calls, EQUAL[case])
    assert first == second


MAKERS = {"sharded": pipeline.make_sharded_cycle,
          "sharded_kinematic": pipeline.make_sharded_kinematic_cycle}


def _built(inp, **changes) -> dict:
    """What the dry run builds its multi-camera cycles from, with changes."""
    return dict(dict(pcfg=inp["pcfg"], mesh=None, intr=inp["intr"], depth_intr=inp["intr"],
                     with_depth=True, with_scene=True, with_texture=False), **changes)


# case -> changes of what a multi-camera cycle is built from: its key must differ from
# (SHARDED_SEPARATE) or equal (SHARDED_EQUAL) the key of the dry run's cycle, on the same
# call arguments.
SHARDED_SEPARATE = {
    "pcfg field": lambda inp: dict(pcfg=inp["pcfg"]._replace(n_update_iterations=1)),
    "intrinsic value": lambda inp: dict(intr=(inp["intr"][0] + 1.0,) + tuple(inp["intr"][1:])),
    "depth intrinsic value": lambda inp: dict(
        depth_intr=tuple(inp["intr"][:3]) + (inp["intr"][3] + 0.5,)),
    "with_depth": lambda inp: dict(with_depth=False),
    "with_scene": lambda inp: dict(with_scene=False),
    "with_texture": lambda inp: dict(with_texture=True),
    "a (1, 1) mesh against None": lambda inp: dict(mesh=parallel.Mesh(1, 1, 0, 0, None,
                                                                        None)),
}

SHARDED_EQUAL = {
    "built again alike": lambda inp: {},
    "intrinsics as a float32 array": lambda inp: dict(
        intr=np.asarray(inp["intr"], np.float32), depth_intr=list(inp["intr"])),
}


def _sharded_keys(inp, calls, name, changes):
    cycle, args, kwargs = calls[name]
    return (cycle.static_key(*args, **kwargs),
            MAKERS[name](**_built(inp, **changes(inp))).static_key(*args, **kwargs))


@pytest.mark.parametrize("case", sorted(SHARDED_SEPARATE))
@pytest.mark.parametrize("name", SHARDED)
def test_sharded_static_key_separates(cpu_problem, cpu_calls, name, case):
    first, second = _sharded_keys(cpu_problem, cpu_calls, name, SHARDED_SEPARATE[case])
    assert first != second


@pytest.mark.parametrize("case", sorted(SHARDED_EQUAL))
@pytest.mark.parametrize("name", SHARDED)
def test_sharded_static_key_equates(cpu_problem, cpu_calls, name, case):
    """Cycles built from equal arguments share one key, as the JAX package's compile
    cache shares one program: a cycle built anew for every call replays one graph."""
    first, second = _sharded_keys(cpu_problem, cpu_calls, name, SHARDED_EQUAL[case])
    assert first == second


def test_static_buffers_hold_one_frame_and_one_model():
    """An expanded (512, 3, 512, 640) uint8 frame and a model expanded over 512 bodies
    get buffers of one frame and one model, which the graph reads expanded again."""
    rng = np.random.default_rng(2)
    frame = torch.as_tensor(rng.integers(0, 255, (1, 3, 512, 640), dtype=np.uint8))
    images = frame.expand(512, 3, 512, 640)
    base, view = graphs.static_buffer(images)
    assert base.shape == (1, 3, 512, 640) and view.shape == images.shape
    assert view.stride() == images.stride() and view.data_ptr() == base.data_ptr()
    base.copy_(images[:1])
    assert torch.equal(view[0], frame[0]) and torch.equal(view[511], frame[0])

    model = pipeline.RegionModelArrays.from_npz(
        str(Path(pipeline.__file__).parent / "data" / "bench_sphere_region_model.npz"),
        200, device="cpu")
    for one, field in zip(model, model.expand(512)):
        base, view = graphs.static_buffer(field)
        assert base.shape == one.shape and view.shape == field.shape
        assert view.stride()[0] == 0 and base.numel() == one.numel()
    state = torch.zeros((512, 4, 4))
    base, view = graphs.static_buffer(state)
    assert base.shape == state.shape and view.stride() == state.stride()


def test_disable_graphs_nests_and_restores():
    assert graphs.graphs_enabled()
    with graphs.disable_graphs():
        assert not graphs.graphs_enabled()
        with graphs.disable_graphs():
            assert not graphs.graphs_enabled()
        assert not graphs.graphs_enabled()
    assert graphs.graphs_enabled()
    with pytest.raises(KeyError), graphs.disable_graphs():
        raise KeyError("inside")
    assert graphs.graphs_enabled()


def _count_calls(fn):
    def counted(t):
        counted.calls += 1
        fn(t)
    counted.calls = 0
    return counted


@graphs.graphed()
def _doubled_then_incremented(x):
    y = x * 2.0
    graphs.collective(_INCREMENT, y)
    return y * 3.0


_INCREMENT = _count_calls(lambda t: t.add_(1.0))


@pytest.mark.parametrize("where", ("eager", "disable_graphs", "graphed on the CPU"))
def test_collective_runs_in_place_outside_a_capture(where):
    """Outside a capture (eagerly, under disable_graphs, a decorated function on the
    CPU) graphs.collective runs fn on the tensor at once, in place."""
    x = torch.arange(4, dtype=torch.float32)
    calls = _INCREMENT.calls
    if where == "graphed on the CPU":
        got = _doubled_then_incremented(x)
        assert torch.equal(got, (x * 2.0 + 1.0) * 3.0) and graphs.captured() == []
    else:
        y = x.clone()
        with graphs.disable_graphs() if where == "disable_graphs" else contextlib.nullcontext():
            graphs.collective(_INCREMENT, y)
        assert torch.equal(y, x + 1.0) and not graphs.capturing()
    assert _INCREMENT.calls == calls + 1


@pytest.mark.parametrize("name", CYCLES)
def test_cycles_on_cpu_run_eagerly(cpu_calls, name):
    """On CPU tensors a decorated cycle is its undecorated function, bit for bit, and
    captures nothing."""
    fn, args, kwargs = cpu_calls[name]
    graphs.clear_graphs()
    got = fn(*args, **kwargs)
    assert _equal(got, fn.__wrapped__(*args, **kwargs))
    assert graphs.captured() == []


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_cycles_on_cpu_run_eagerly(cpu_calls, name):
    """On CPU tensors a multi-camera cycle is its eager form (disable_graphs), bit for
    bit, and captures nothing."""
    fn, args, kwargs = cpu_calls[name]
    graphs.clear_graphs()
    got = fn(*args, **kwargs)
    with graphs.disable_graphs():
        assert _equal(got, fn(*args, **kwargs))
    assert graphs.captured() == []


@pytest.mark.parametrize("name", SHARDED)
def test_sharded_bool_handle_occlusions(cpu_calls, name):
    """A bool handle_occlusions (keyed by value, filled on the device) equals the same
    flag as a tensor for every body or link, and True equals None."""
    fn, args, kwargs = cpu_calls[name]
    shape = kwargs["handle_occlusions"].shape
    for flag, same in ((False, torch.zeros(shape, dtype=torch.bool)), (True, None)):
        assert _equal(fn(*args, handle_occlusions=flag), fn(*args, handle_occlusions=same))


@pytest.mark.parametrize("name", CYCLES + SHARDED)
def test_cycles_read_nothing_back_on_the_host(cpu_calls, name, monkeypatch):
    """No operation of a cycle reads a value back on the host (item, tolist, numpy, cpu,
    a data-dependent shape) or builds a tensor on the cycle's device from host data: a
    CUDA graph's capture refuses both.  Shown on the CPU for every optional input the
    dry run's problem takes; the kernels' plain twins, which run on the CPU only, are
    left out (tests/torch_host_reads.py)."""
    fn, args, kwargs = cpu_calls[name]
    torch_host_reads.assert_reads_nothing_back(fn, args, kwargs, monkeypatch)


NUMPY_INTR = np.array([500, 500, 4, 4], np.float32)


def test_numpy_camera_values_key_by_value(cpu_calls):
    """A numpy array as tracking_cycle's intr, and a 0-d one as tracking_cycle_rgbd's
    depth_scale, key by value (JAX traces both): equal arrays key equal, unequal ones
    apart."""
    _, args, kwargs = cpu_calls["region"]

    def region_key(intr):
        return graphs.static_key(pipeline.tracking_cycle, args[0], intr, *args[2:], **kwargs)

    assert region_key(NUMPY_INTR) == region_key(NUMPY_INTR.copy())
    assert region_key(NUMPY_INTR) != region_key(NUMPY_INTR + np.float32([0, 0, 0, 1]))
    assert region_key(NUMPY_INTR) != region_key(NUMPY_INTR.astype(np.float64))
    _, args, kwargs = cpu_calls["rgbd"]

    def rgbd_key(depth_scale):
        return graphs.static_key(pipeline.tracking_cycle_rgbd, *args[:3], depth_scale,
                                 *args[4:], **kwargs)

    scale = np.array(dryrun.DEPTH_SCALE, np.float32)
    assert rgbd_key(scale) == rgbd_key(scale.copy())
    assert rgbd_key(scale) != rgbd_key(scale * np.float32(1.1))


def test_numpy_camera_values_run_as_numbers(cpu_calls):
    """A numpy intr and depth_scale give the state that the same values as a tuple and a
    float give."""
    fn, args, kwargs = cpu_calls["rgbd"]
    args = list(args)
    want = fn(*args, **kwargs)
    args[1], args[3] = np.asarray(args[1]), np.array(args[3])
    assert _equal(fn(*args, **kwargs), want)


# Every hand-written kernel's wrapper, each of which counts its launches.
KERNEL_COUNTERS = (region_fast.sample_lines, region_fast.bin_counts,
                   depth_fast.sample_windows, occlusion.query_eval, newton.newton_step,
                   occlusion.scene_coeffs)


def test_kernel_counters_are_every_wrapper():
    """A graph adds the launches of exactly the six kernel wrappers to their counts: the
    wrappers that ops/_cuda.py declares, each under its module's name."""
    counted = _cuda.wrappers()
    assert len(counted) == len(KERNEL_COUNTERS) and set(counted) == set(KERNEL_COUNTERS)
    for fn in counted:
        assert getattr(sys.modules[fn.__module__], fn.__name__) is fn
        assert fn.symbol == f"m3t_{fn.__name__}"


# ---------------------------------------------------------------------------------------
# On the card (marker "cuda")
# ---------------------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    graphs.clear_graphs()
    yield
    graphs.clear_graphs()


@pytest.fixture
def cuda_calls(card):
    return _calls(dryrun.problem(torch.device("cuda"), 1))


def _chain(fn, args, kwargs, n: int, at: int | None = None) -> list:
    """n cycles, each from the state the last one gave (args[at]; by default where fn,
    a one-camera cycle, takes it)."""
    if at is None:
        at = 5 if fn is pipeline.tracking_cycle_kinematic else (
            8 if fn is pipeline.tracking_cycle_rgbd else 4)
    args, states = list(args), []
    for _ in range(n):
        states.append(fn(*args, **kwargs))
        args[at] = states[-1]
    return states


@pytest.mark.cuda
@pytest.mark.parametrize("name", CYCLES)
def test_graph_equals_eager_on_card(cuda_calls, name):
    """Three graphed cycles (the capturing call and two replays) equal three eager ones
    bit for bit, and replay one graph."""
    fn, args, kwargs = cuda_calls[name]
    with graphs.disable_graphs():
        eager = _chain(fn, args, kwargs, 3)
    assert graphs.captured() == []
    graphed = _chain(fn, args, kwargs, 3)
    for want, got in zip(eager, graphed):
        assert _equal(want, got)
    (info,) = graphs.captured()
    assert info.replays == 2 and info.name == fn.__qualname__


@pytest.mark.cuda
def test_numpy_camera_values_on_card(cuda_calls):
    """Graphed, a numpy intr and depth_scale (keyed apart from the tuple and the float)
    give the states that the tuple and the float give, bit for bit."""
    fn, args, kwargs = cuda_calls["rgbd"]
    want = _chain(fn, args, kwargs, 2)
    args = list(args)
    args[1], args[3] = np.asarray(args[1]), np.array(args[3])
    for w, g in zip(want, _chain(fn, args, kwargs, 2)):
        assert _equal(w, g)
    assert [i.replays for i in graphs.captured()] == [1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CYCLES)
def test_graph_outputs_are_fresh(cuda_calls, name):
    """A later call leaves an earlier call's outputs as they were: they share no memory
    with the graph's buffers."""
    fn, args, kwargs = cuda_calls[name]
    first = fn(*args, **kwargs)
    kept = [a.clone() for a in first]
    second = fn(*args, **kwargs)
    third = _chain(fn, args, kwargs, 2)[-1]
    assert _equal(first, kept) and _equal(first, second)
    assert not _equal(third, first)
    pointers = {a.untyped_storage().data_ptr() for out in (first, second) for a in out}
    assert len(pointers) == 2 * len(first)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CYCLES)
def test_graph_launch_counts_per_replay(cuda_calls, name):
    """Every call counts its eager twin's kernel launches: the capturing call its
    warm-up's, each replay those the capture recorded."""
    fn, args, kwargs = cuda_calls[name]
    counters = KERNEL_COUNTERS

    def counted(call):
        before = [c.launches for c in counters]
        call()
        return [c.launches - n for c, n in zip(counters, before)]

    with graphs.disable_graphs():
        eager = counted(lambda: fn(*args, **kwargs))
    assert eager[0] > 0 and eager[1] == 2
    for _ in range(3):
        assert counted(lambda: fn(*args, **kwargs)) == eager
    (info,) = graphs.captured()
    assert sum(info.launches.values()) == sum(eager)


@pytest.mark.cuda
def test_capture_failure_raises(cuda_calls):
    """A function that reads a value back on the host raises at its capture, naming it,
    and never runs eagerly in the graph's place."""

    @graphs.graphed()
    def scaled(x):
        return x * x.sum().item()

    x = torch.ones(8, device="cuda")
    with graphs.disable_graphs():
        assert torch.equal(scaled(x), x * 8.0)
    for _ in range(2):
        with pytest.raises(RuntimeError, match=r"scaled: capturing its CUDA graph failed "
                                               r"at .*x\.sum\(\)\.item\(\)"):
            scaled(x)
    assert graphs.captured() == []
    torch.cuda.synchronize()
    assert torch.equal(scaled.__wrapped__(x), x * 8.0)
    # Later captures take a pool of their own and succeed.
    fn, args, kwargs = cuda_calls["region"]
    with graphs.disable_graphs():
        eager = _chain(fn, args, kwargs, 2)
    for want, got in zip(eager, _chain(fn, args, kwargs, 2)):
        assert _equal(want, got)


@pytest.mark.cuda
@pytest.mark.parametrize("name", SHARDED)
def test_sharded_graph_equals_eager_on_card(cuda_calls, name):
    """B=2, C=2, mesh=None: three graphed multi-camera cycles (the capturing call and two
    replays) equal three eager ones bit for bit and count the eager launches each; one
    graph of one segment (no collective without a camera group)."""
    fn, args, kwargs = cuda_calls[name]
    at = 3 if name == "sharded" else 4

    def launches(run):
        before = [c.launches for c in KERNEL_COUNTERS]
        out = run()
        return out, [c.launches - n for c, n in zip(KERNEL_COUNTERS, before)]

    with graphs.disable_graphs():
        eager, eager_launches = launches(lambda: _chain(fn, args, kwargs, 3, at))
    graphed, graph_launches = launches(lambda: _chain(fn, args, kwargs, 3, at))
    for want, got in zip(eager, graphed):
        assert _equal(want, got)
    assert graph_launches == eager_launches and eager_launches[0] > 0
    (info,) = graphs.captured()
    assert info.replays == 2 and info.segments == 1
    assert sum(info.launches.values()) * 3 == sum(eager_launches)


@pytest.mark.cuda
def test_collective_splits_the_graph_on_card(card):
    """A collective (here a plain in-place add) between two captured segments: it runs
    once in the warm-up, never at the capture, and once between the segments of every
    replay, in capture order."""
    xs = [torch.arange(4, dtype=torch.float32, device="cuda") + i for i in range(3)]
    calls = _INCREMENT.calls
    got = [_doubled_then_incremented(x) for x in xs]
    for x, y in zip(xs, got):
        assert torch.equal(y, (x * 2.0 + 1.0) * 3.0)
    (info,) = graphs.captured()
    assert info.segments == 2 and info.replays == 2
    assert _INCREMENT.calls == calls + 3
