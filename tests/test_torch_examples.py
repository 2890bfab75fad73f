"""Parity tests: the port's entry points under m3t_tpu_torch/examples/ against the JAX
package's scripts under examples/, on the CPU.

Each test runs the JAX script's ``main()`` (``sys.argv`` patched, ``examples/`` on
``sys.path`` for its ``parameter_study_common`` import) and the port's
``main([..., "--device", "cpu"])`` on the same files: the mini datasets of
tests/test_evaluators.py, tests/test_evaluators_extra.py and
tests/test_torch_evaluators.py, and the generator configs of tests/test_torch_generator.py.
Printed lines must agree word for word and every number in them within 1e-4 (the
seconds a study row took aside); scored and final poses within 1e-4.  The evaluators are
bound to the mini datasets' intrinsics and to small models in both packages, as
tests/test_torch_evaluators.py binds them.
"""

import importlib
import itertools
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import m3t_tpu.body
import m3t_tpu_torch.body
from m3t_tpu_torch.common import Intrinsics as TIntrinsics
from tests import fixtures
from tests.test_torch_generator import N_FRAMES as GEN_FRAMES
from tests.test_hardware_cameras import fake_pyk4a, fake_rs  # noqa: F401 (fixtures)
from tests.test_torch_generator import ball_pose, config_dir  # noqa: F401 (fixture)
from tests.test_torch_evaluators import MetricSpy, _pipeline_config

REPO = Path(__file__).resolve().parents[1]
ATOL = 1e-4
N_FRAMES = 3
SMALL_MODEL = dict(n_divides=1, n_points=200, image_size=400)
NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]?\d+)?|-?\d+")
ELAPSED = re.compile(r" \(\d+\.\d s\)$")
MODEL_NOTE = re.compile(r"^(Start|Finish) generating ")  # whichever package runs first


def _jax_script(name: str, monkeypatch):
    """The JAX script examples/<name>.py, imported with examples/ on sys.path."""
    monkeypatch.syspath_prepend(str(REPO / "examples"))
    return importlib.import_module(name)


def _port_script(name: str):
    return importlib.import_module(f"m3t_tpu_torch.examples.{name}")


def _fresh_ids(patch) -> None:
    """Body ids counted from 1 in both packages (they reach the silhouette ids)."""
    for body_module in (m3t_tpu.body, m3t_tpu_torch.body):
        patch.setattr(body_module, "_next_body_id", itertools.count(1))


def _run(pkg: str, name: str, argv, monkeypatch, capsys, patches=(), on_cpu=True):
    """(exit code, printed lines) of one entry point's main() in pkg, with ``patches``
    ((owner, attribute, value) triples) in place and body ids counted from 1; the port's
    is given ``--device cpu`` where on_cpu is set."""
    capsys.readouterr()
    with monkeypatch.context() as patch:
        _fresh_ids(patch)
        for owner, attribute, value in patches:
            patch.setattr(owner, attribute, value)
        if pkg == "jax":
            module = _jax_script(name, patch)
            patch.setattr(sys, "argv", [f"{name}.py", *argv])
            rc = module.main()
        else:
            rc = _port_script(name).main([*argv, "--device", "cpu"] if on_cpu else argv)
    return rc, capsys.readouterr().out.splitlines()


def _assert_same_lines(got, want, skip=lambda line: False):
    """The same lines, word for word once numbers are masked, and every number within
    ATOL; a study row's seconds and the notes of model generation are not compared."""
    got, want = ([line for line in lines if not MODEL_NOTE.match(line)]
                 for lines in (got, want))
    assert len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        if skip(w):
            continue
        g, w = ELAPSED.sub("", g), ELAPSED.sub("", w)
        assert NUMBER.sub("#", g) == NUMBER.sub("#", w), (g, w)
        for a, b in zip(NUMBER.findall(g), NUMBER.findall(w)):
            assert abs(float(a) - float(b)) <= ATOL, (g, w)


def _small_evaluator(module, cls_name: str, **attributes):
    """module.<cls_name> with small models (SMALL_MODEL) and ``attributes`` set after
    its constructor, for a study script to construct."""
    base = getattr(module, cls_name)

    def small_model(model):
        for key, value in SMALL_MODEL.items():
            setattr(model, key, value)

    class Small(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.region_model_setter = small_model
            if hasattr(self, "depth_model_setter"):
                self.depth_model_setter = small_model
            for key, value in attributes.items():
                setattr(self, key, value)

    return Small


def _evaluator_patches(evaluator_module: str, cls_name: str, intr=None, pipeline=None,
                       **attributes):
    """(patches, spies) for both packages: the evaluator module's class made small
    (_small_evaluator, intrinsics bound where given, and the fused path's
    pipeline_config where ``pipeline`` gives _pipeline_config's keywords) and its
    metrics spied on."""
    patches, spies = {}, {}
    for pkg, prefix in (("jax", "m3t_tpu.eval"), ("torch", "m3t_tpu_torch.eval")):
        module = importlib.import_module(f"{prefix}.{evaluator_module}")
        extra = dict(attributes)
        if intr is not None:
            extra["intrinsics"] = TIntrinsics(*intr) if pkg == "torch" else intr
        if pipeline is not None:
            extra["pipeline_config"] = _pipeline_config(pkg, **pipeline)
        spies[pkg] = MetricSpy(module.metrics)
        patches[pkg] = [(module, cls_name, _small_evaluator(module, cls_name, **extra)),
                        (module, "metrics", spies[pkg])]
    return patches, spies


def _assert_same_poses(spies):
    got, want = spies["torch"].pairs, spies["jax"].pairs
    assert len(got) == len(want) > 0
    for i, ((pose, gt), (jpose, jgt)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(gt, jgt)
        np.testing.assert_allclose(pose, jpose, rtol=0, atol=ATOL, err_msg=f"pose {i}")


def _both(name, argv, monkeypatch, capsys, patches):
    runs = {pkg: _run(pkg, name, argv, monkeypatch, capsys, patches[pkg])
            for pkg in ("jax", "torch")}
    assert runs["torch"][0] == runs["jax"][0] == 0
    return runs["torch"][1], runs["jax"][1]


# ---------------------------------------------------------------------------------------
# The shared sweep machinery and the optimizer timing
# ---------------------------------------------------------------------------------------


GRIDS = {"region_modality": {"n_lines_max": [100, 200], "scales": [[5, 2, 2, 1]],
                             "learning_rate_f": [0.1, 0.2, 0.3]},
         "tracker": {"n_corr_iterations": [7]},
         "optimizer": {"tikhonov_parameter_rotation": [1000.0, 2000.0]}}


def test_parameter_study_common_is_the_root_module(monkeypatch, capsys):
    """expand_grid, make_setter, describe and run_study of the port's copy return and
    print what examples/parameter_study_common.py does on a mixed grid."""
    theirs = _jax_script("parameter_study_common", monkeypatch)
    ours = _port_script("parameter_study_common")
    runs = ours.expand_grid(GRIDS)
    assert runs == theirs.expand_grid(GRIDS) and len(runs) == 12
    assert [ours.describe(r, GRIDS) for r in runs] == [theirs.describe(r, GRIDS)
                                                       for r in runs]
    assert ours.describe(runs[0], {"tracker": {"n_corr_iterations": [7]}}) == \
        "(default configuration)"
    for setter in (ours.make_setter, theirs.make_setter):
        obj = type("Modality", (), {})()
        setter({"n_lines_max": 100, "scales": [2, 1]})(obj)
        assert vars(obj) == {"n_lines_max": 100, "scales": [2, 1]}

    def evaluate_one(run):
        r = run["region_modality"]
        return {"score": r["n_lines_max"] * r["learning_rate_f"], "other": -1.0}

    printed = {}
    for name, module in (("jax", theirs), ("torch", ours)):
        capsys.readouterr()
        rows = module.run_study(GRIDS, evaluate_one, ("score", "other"))
        printed[name] = capsys.readouterr().out.splitlines()
        assert [r["run"] for r in rows] == runs
        assert [r["score"] for r in rows] == [evaluate_one(r)["score"] for r in runs]
    _assert_same_lines(printed["torch"], printed["jax"])
    assert printed["torch"][0] == "Running 12 experiment(s)"
    assert printed["torch"][-1].startswith("best score: 60.0000 with {")


def _chain_step(module, terms):
    """The link poses of module.make_chain(5) before and after one
    CalculateOptimization step: with terms=None under the script's own injection
    (AddToGradientAndHessian), else with each link's CalculateGradientAndHessian giving
    its (gradient, Hessian) from terms."""
    optimizer, links = module.make_chain(5)
    rng = np.random.default_rng(7)
    for k, link in enumerate(links):
        if terms is None:
            link.AddToGradientAndHessian(rng.normal(size=6).astype(np.float32),
                                         -np.eye(6, dtype=np.float32) * rng.uniform(10, 100))
        else:
            def calculate(link=link, g=terms[k][0], h=terms[k][1]):
                link.gradient, link.hessian = g, h
                return True
            link.CalculateGradientAndHessian = calculate
    before = np.stack([np.asarray(link.link2world_pose) for link in links])
    assert optimizer.CalculateOptimization(0, 0, 0)
    return before, np.stack([np.asarray(link.link2world_pose) for link in links])


def test_optimization_time_matches_jax(monkeypatch, capsys):
    """The table's chain and dof columns equal the JAX script's.  One
    CalculateOptimization step of a 5-link chain moves every link as JAX's does, within
    1e-5, when each link's gradient and Hessian come from its terms; under the script's
    own injection the step moves nothing in either package, since the step recomputes
    every link's terms from its modalities, and the chain has none (ROADMAP Queue C)."""
    argv = ["--max-chain", "8", "--n-runs", "3"]
    got, want = (_run(pkg, "optimization_time", argv, monkeypatch, capsys)
                 for pkg in ("torch", "jax"))
    assert got[0] == want[0] == 0
    assert [line.split()[:2] for line in got[1]] == [line.split()[:2] for line in want[1]]
    assert [line.split()[1] for line in got[1][1:]] == ["6", "7", "10", "15", "13"]

    modules = {"jax": _jax_script("optimization_time", monkeypatch),
               "torch": _port_script("optimization_time")}
    rng = np.random.default_rng(7)
    terms = [(rng.normal(size=6).astype(np.float32),
              -np.diag(rng.uniform(10, 100, 6)).astype(np.float32)) for _ in range(5)]
    steps = {pkg: _chain_step(module, terms) for pkg, module in modules.items()}
    np.testing.assert_array_equal(steps["torch"][0], steps["jax"][0])
    moved = np.abs(steps["torch"][1] - steps["torch"][0]).max(axis=(1, 2))
    assert np.all(moved > 1e-4), moved
    np.testing.assert_allclose(steps["torch"][1], steps["jax"][1], rtol=0, atol=1e-5)
    for module in modules.values():
        before, after = _chain_step(module, None)
        np.testing.assert_array_equal(after, before)


# ---------------------------------------------------------------------------------------
# A recorded sequence: record_camera_sequence, then run_on_recorded_sequence
# ---------------------------------------------------------------------------------------


def _path_pose(i: int) -> np.ndarray:
    """The recorded sphere's pose in frame i: 2 mm along x per frame, 0.6 m away."""
    pose = np.eye(4, dtype=np.float32)
    pose[0, 3] = 0.002 * i
    pose[2, 3] = 0.6
    return pose


class _RecordedVideoCapture:
    """Stands in for cv2.VideoCapture: the sphere along _path_pose at 640x480, seen
    through the OpenCV camera's fallback intrinsics.  The camera's set-up probe reads
    frame 0, and its k-th UpdateImage frame k."""

    def __init__(self, index):
        from m3t_tpu_torch.common import Intrinsics

        self.index, self.n_reads = index, 0
        f = 640 / (2.0 * np.tan(np.deg2rad(30.0)))
        intr = Intrinsics(f, f, 640 / 2 - 0.5, 480 / 2 - 0.5, 640, 480)
        body = fixtures.sphere_body("recorded_ball", radius=0.06, n_subdiv=2)
        rng = np.random.default_rng(21)
        self.frames = [fixtures.render_synthetic_color_frame(body, intr, _path_pose(i),
                                                              noise_rng=rng)
                       for i in range(N_FRAMES)]

    def isOpened(self):  # noqa: N802
        return True

    def read(self):
        frame = self.frames[max(self.n_reads - 1, 0)]
        self.n_reads += 1
        return True, frame.copy()


def _record(tmp_path, monkeypatch, capsys) -> dict:
    """record_camera_sequence in both packages through _RecordedVideoCapture into
    <tmp>/<pkg>/: the same file names, PNG pixels (read by cv2) and metafile bytes, and
    the same printed line but for the directory.  (Its --device is the video device's
    index in both packages.)"""
    import cv2

    monkeypatch.setattr(cv2, "VideoCapture", _RecordedVideoCapture)
    out = {}
    for pkg in ("jax", "torch"):
        out[pkg] = tmp_path / pkg
        argv = [str(out[pkg]), "--device", "2", "--n-frames", str(N_FRAMES), "--fps", "1000"]
        rc, lines = _run(pkg, "record_camera_sequence", argv, monkeypatch, capsys,
                         on_cpu=False)
        assert rc == 0 and lines == [f"Recorded {N_FRAMES} frames to {out[pkg]}"]
    names = {pkg: sorted(p.name for p in d.iterdir()) for pkg, d in out.items()}
    assert names["torch"] == names["jax"] == sorted(
        ["color_camera.yaml"] + [f"color_camera_image_{i}.png" for i in range(N_FRAMES)])
    assert ((out["torch"] / "color_camera.yaml").read_bytes()
            == (out["jax"] / "color_camera.yaml").read_bytes())
    frames = _RecordedVideoCapture(0).frames
    for i in range(N_FRAMES):
        png = f"color_camera_image_{i}.png"
        for pkg in ("torch", "jax"):
            np.testing.assert_array_equal(
                cv2.imread(str(out[pkg] / png), cv2.IMREAD_UNCHANGED), frames[i])
    return out


def _final_pose(lines) -> np.ndarray:
    """run_on_recorded_sequence's printed final pose."""
    assert lines[-5] == "final body2world_pose:"
    return np.array([[float(v) for v in NUMBER.findall(line)] for line in lines[-4:]])


@pytest.mark.parametrize("host_path", [
    pytest.param(False, id="fused"),
    pytest.param(True, id="host path", marks=pytest.mark.slow)])
def test_recorded_sequence_matches_jax(tmp_path, monkeypatch, capsys, host_path):
    """A recording through a faked cv2.VideoCapture (the same PNG files and metafile
    bytes in both packages), replayed by run_on_recorded_sequence through the metafile
    the recorder wrote, in both packages, on the fused path or with --host-path: the
    same printed lines and final pose within 1e-4, within 5 mm of the sphere's last
    frame."""
    from m3t_tpu_torch.utils.obj_loader import save_obj

    recorded = _record(tmp_path, monkeypatch, capsys)
    body = fixtures.sphere_body("recorded_ball", radius=0.06, n_subdiv=2)
    save_obj(str(tmp_path / "ball.obj"), body.vertices, body.triangles)
    start = _path_pose(0)
    start[0, 3] += 0.003
    data = ", ".join(f"{v:g}" for v in start.reshape(-1))
    (tmp_path / "detector.yaml").write_text(
        "%YAML:1.2\nlink2world_pose: !!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: f\n"
        f"  data: [{data}]\n")
    (tmp_path / "external").mkdir()
    runs = {}
    for pkg in ("jax", "torch"):
        argv = [str(recorded[pkg]), str(tmp_path / "ball.obj"), str(tmp_path / "detector.yaml"),
                str(tmp_path / "external"), "--camera-metafile",
                str(recorded[pkg] / "color_camera.yaml"), "--n-frames", str(N_FRAMES),
                "--n-divides", "1", "--model-image-size", "400"]
        runs[pkg] = _run(pkg, "run_on_recorded_sequence",
                         argv + (["--host-path"] if host_path else []), monkeypatch, capsys)
        assert runs[pkg][0] == 0
    (_, got), (_, want) = runs["torch"], runs["jax"]
    _assert_same_lines(got, want)
    assert [line for line in got if "fused cycle unavailable" in line] == []
    pose = _final_pose(got)
    np.testing.assert_allclose(pose, _final_pose(want), rtol=0, atol=ATOL)
    assert np.abs(pose[:3, 3] - _path_pose(N_FRAMES - 1)[:3, 3]).max() < 0.005


# ---------------------------------------------------------------------------------------
# Generated trackers: run_generated_tracker and the pen demo's publisher
# ---------------------------------------------------------------------------------------


def _generated(pkg: str, monkeypatch, trackers: dict):
    """(owner, name, wrapper) patching the package's GenerateConfiguredTracker where the
    script looks it up, so that the tracker it builds lands in trackers[pkg]."""
    if pkg == "jax":
        import m3t_tpu.generator as generator
        owner = _jax_script("run_generated_tracker", monkeypatch)
    else:
        import m3t_tpu_torch.generator as generator
        owner = _port_script("run_generated_tracker")
    real = generator.GenerateConfiguredTracker

    def generate(path, **kwargs):
        trackers[pkg] = real(path, **kwargs)
        return trackers[pkg]
    return [(owner, "GenerateConfiguredTracker", generate)]


# tests/test_torch_generator.py's ball with its region modality alone, from that test's
# metafiles: a generated graph that each package sets up and steps in seconds.
REGION_LINK = """%YAML:1.2
Body:
  - name: "ball"
    metafile_path: "ball.yaml"
LoaderColorCamera:
  - name: "color_camera"
    metafile_path: "color_camera.yaml"
RegionModel:
  - name: "ball_region_model"
    metafile_path: "region_model.yaml"
    body: "ball"
RegionModality:
  - name: "ball_region"
    metafile_path: "region_modality.yaml"
    body: "ball"
    color_camera: "color_camera"
    region_model: "ball_region_model"
Link:
  - name: "ball_link"
    body: "ball"
    modalities: ["ball_region"]
Optimizer:
  - name: "optimizer"
    root_link: "ball_link"
StaticDetector:
  - name: "detector"
    metafile_path: "static_detector.yaml"
    optimizer: "optimizer"
Tracker:
  - name: "tracker"
    metafile_path: "tracker.yaml"
    optimizers: ["optimizer"]
    detectors: ["detector"]
"""


@pytest.fixture
def generator_configs(config_dir):
    """tests/test_torch_generator.py's config directory with region_link.yaml beside
    its one_link.yaml (region, depth and texture modalities with every scene check, a
    refiner and viewers)."""
    (config_dir / "region_link.yaml").write_text(REGION_LINK)
    return config_dir


@pytest.mark.parametrize("config", [
    "region_link.yaml", pytest.param("one_link.yaml", marks=pytest.mark.slow)])
def test_run_generated_tracker_matches_jax(generator_configs, monkeypatch, capsys, config):
    """run_generated_tracker over a generator config for its frames: exit 0 in both
    packages, every link pose and histogram within 1e-4, the ball within 4 mm of its
    last frame's pose (across the image alone with the region modality alone, which
    observes depth only through the silhouette's size)."""
    from m3t_tpu_torch import fused_serve

    trackers = {}
    argv = [str(generator_configs / config), "--max-iterations", str(GEN_FRAMES)]
    for pkg in ("jax", "torch"):
        rc, _ = _run(pkg, "run_generated_tracker", argv, monkeypatch, capsys,
                     _generated(pkg, monkeypatch, trackers))
        assert rc == 0
    got, want = (fused_serve.read_graph_state(trackers[pkg]) for pkg in ("torch", "jax"))
    for group in ("links", "histograms"):
        assert got[group].keys() == want[group].keys()
        for name in want[group]:
            for a, b in zip(got[group][name], want[group][name]):
                np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)
    ball = got["links"]["ball_link"][2]
    axes = 2 if config == "region_link.yaml" else 3
    assert np.abs(ball[:axes, 3] - ball_pose(GEN_FRAMES - 1)[:axes, 3]).max() < 0.004


def test_pen_paper_demo_matches_jax(generator_configs, monkeypatch, capsys):
    """run_pen_paper_demo over the region-link config in both packages.  Its main() adds
    the publisher after Tracker.SetUp, which unsets the tracker (AddPublisher), so
    RunTrackerProcess refuses to run and the demo exits 1 with no trajectory: a fault
    of the JAX script (ROADMAP Queue C) that the port keeps.  The DrawingPublisher
    itself, with the tracker set up again after it is added, projects the same tip
    trajectory in both packages and draws the same canvases (cv2.imshow recorded, a
    display assumed for the port)."""
    import cv2

    argv = [str(generator_configs / "region_link.yaml"), "--max-iterations",
            str(GEN_FRAMES), "--tip", "0.0", "0.05", "0.0"]
    for pkg in ("jax", "torch"):
        rc, lines = _run(pkg, "run_pen_paper_demo", argv, monkeypatch, capsys)
        assert (rc, [line for line in lines if not MODEL_NOTE.match(line)]) == (
            1, ["Set up tracker tracker first", "trajectory points: 0"]), pkg

    shown = {}
    monkeypatch.setenv("DISPLAY", ":0")
    monkeypatch.setattr(cv2, "waitKey", lambda delay: -1)
    for pkg in ("jax", "torch"):
        monkeypatch.setattr(cv2, "imshow", lambda title, image, pkg=pkg:
                            shown.setdefault(pkg, []).append(image.copy()))
        if pkg == "jax":
            from m3t_tpu.generator import GenerateConfiguredTracker
            module = _jax_script("run_pen_paper_demo", monkeypatch)
            tracker = GenerateConfiguredTracker(argv[0])
        else:
            from m3t_tpu_torch.generator import GenerateConfiguredTracker
            module = _port_script("run_pen_paper_demo")
            tracker = GenerateConfiguredTracker(argv[0], device="cpu")
        with monkeypatch.context() as patch:
            _fresh_ids(patch)
            assert tracker.SetUp()
            publisher = module.DrawingPublisher("drawing_publisher", tracker.body_ptrs[0],
                                                tracker.camera_ptrs[0], [0.0, 0.05, 0.0])
            tracker.AddPublisher(publisher)
            assert tracker.SetUp()
            assert tracker.RunTrackerProcess(execute_detection=True, start_tracking=True,
                                             max_iterations=GEN_FRAMES)
        shown[pkg + " trajectory"] = publisher.trajectory
    assert shown["torch trajectory"] == shown["jax trajectory"]
    assert len(shown["torch trajectory"]) == GEN_FRAMES
    assert len(shown["torch"]) == len(shown["jax"]) == GEN_FRAMES
    for got, want in zip(shown["torch"], shown["jax"]):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------------------
# The live camera graph, with faked SDKs
# ---------------------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["opencv", "kinect", "realsense"])
def test_camera_sequence_graph_sets_up_with_faked_sdks(tmp_path, monkeypatch, backend,
                                                       fake_pyk4a, fake_rs):  # noqa: F811
    """run_on_camera_sequence.build_tracker for each backend (cv2.VideoCapture, pyk4a
    and pyrealsense2 faked as tests/test_hardware_cameras.py fakes them; the region
    model cut to one subdivision) sets up: the backend's camera, a ManualDetector with
    the metafile's reference points, the NormalColorViewer and the fused tracker, every
    tensor on the CPU."""
    import functools

    import cv2

    from m3t_tpu_torch import hardware_camera
    from m3t_tpu_torch.region_model import RegionModel
    from m3t_tpu_torch.utils.obj_loader import save_obj
    from tests.test_hardware_cameras import _FakeVideoCapture

    module = _port_script("run_on_camera_sequence")
    monkeypatch.setattr(cv2, "VideoCapture", _FakeVideoCapture)
    monkeypatch.setattr(module, "RegionModel", functools.partial(
        RegionModel, n_divides=1, n_points=100, image_size=200))
    body = fixtures.sphere_body("live_ball", radius=0.06, n_subdiv=1)
    save_obj(str(tmp_path / "ball.obj"), body.vertices, body.triangles)
    points = [0.0, 0.0, 0.06, 0.06, 0.0, 0.0, 0.0, 0.06, 0.0, -0.06, 0.0, 0.0]
    (tmp_path / "detector.yaml").write_text(f"%YAML:1.2\nreference_points: {points}\n")
    args = module.parse_args([str(tmp_path / "ball.obj"), str(tmp_path / "detector.yaml"),
                              str(tmp_path), "--backend", backend, "--device", "cpu"])
    cameras = {"opencv": hardware_camera.OpenCVColorCamera,
               "kinect": hardware_camera.AzureKinectColorCamera,
               "realsense": hardware_camera.RealSenseColorCamera}
    for shared in (hardware_camera.AzureKinect, hardware_camera.RealSense):
        shared.reset_instance()
    try:
        tracker = module.build_tracker(args)
        assert tracker.SetUp()
        (camera,) = tracker.camera_ptrs
        assert type(camera) is cameras[backend] and camera.set_up
        (detector,) = tracker.detector_ptrs
        np.testing.assert_array_equal(detector.reference_points3d.reshape(-1),
                                      np.float32(points))
        (modality,) = tracker.modality_ptrs
        assert modality.device.type == "cpu" and tracker.use_fused_cycle
        (viewer,) = tracker.viewer_ptrs
        assert type(viewer).__name__ == "NormalColorViewer" and viewer.set_up
        assert viewer.renderer_geometry_ptr.device.type == "cpu"
    finally:
        for shared in (hardware_camera.AzureKinect, hardware_camera.RealSense):
            shared.reset_instance()


# ---------------------------------------------------------------------------------------
# Imports and the card
# ---------------------------------------------------------------------------------------


ENTRY_POINTS = ("optimization_time", "parameter_study", "parameter_study_common",
                "parameter_study_rbot_dataset", "parameter_study_ycb_dataset",
                "parameter_study_opt_dataset", "parameter_study_choi_dataset",
                "parameter_study_rtb_dataset", "record_camera_sequence",
                "run_generated_tracker", "run_on_camera_sequence",
                "run_on_recorded_sequence", "run_pen_paper_demo")


def test_entry_points_import_neither_jax_nor_cv2():
    """Sibling of tests/test_torch_evaluators.py::
    test_eval_and_entry_points_import_neither_jax_nor_cv2 for the twelve entry points
    of this slice and the study machinery's copy: importing them imports no jax,
    m3t_tpu, cv2, camera SDK, nor the root examples/ scripts."""
    code = (
        "import sys\n"
        "sys.path.insert(0, 'examples')\n"
        f"from m3t_tpu_torch.examples import {', '.join(ENTRY_POINTS)}\n"
        "roots = ('jax', 'm3t_tpu', 'cv2', 'pyk4a', 'pyrealsense2', 'parameter_study_common')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in roots)\n"
        "assert not bad, bad\n"
        f"assert all(getattr(sys.modules['m3t_tpu_torch.examples.' + n], '__file__', '')"
        f".startswith({str(REPO / 'm3t_tpu_torch')!r}) for n in {ENTRY_POINTS!r})\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# Arguments that reach each entry point's graph (none of their files exist: the device
# is refused first).
WITHOUT_DEVICE = {
    "optimization_time": [],
    "parameter_study": ["rbot", "d", "e"],
    "parameter_study_rbot_dataset": ["d", "e"],
    "parameter_study_ycb_dataset": ["d", "e"],
    "parameter_study_opt_dataset": ["d", "e"],
    "parameter_study_choi_dataset": ["d", "e"],
    "parameter_study_rtb_dataset": ["d", "e"],
    "run_generated_tracker": ["config.yaml"],
    "run_on_camera_sequence": ["body.obj", "detector.yaml", "e"],
    "run_on_recorded_sequence": ["s", "body.obj", "detector.yaml", "e"],
    "run_pen_paper_demo": ["config.yaml"],
}


@pytest.mark.parametrize("name", sorted(WITHOUT_DEVICE))
def test_entry_points_default_to_the_card(tmp_path, monkeypatch, capsys, name):
    """Without a card, each entry point that builds a graph raises naming cuda when it
    is called without --device, before it prints or reads anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        _port_script(name).main(WITHOUT_DEVICE[name])
    assert capsys.readouterr().out == ""
    assert list(tmp_path.iterdir()) == []
