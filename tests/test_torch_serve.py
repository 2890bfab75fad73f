"""Parity tests: the port's reference-shaped serve path (cameras, modalities, links,
optimizers, detectors, the Tracker and its fused serve backend) against the JAX
package's, on the CPU.

The graph is tests/test_fused_serve.py's: a sphere (radius 0.06 m) 0.6 m from a 160x120
camera, moving 2 mm along x and -1 mm along y per frame, one RegionModality (100 lines,
scales {2, 1}), 4x2 iterations, a StaticDetector 4 mm off; the RGB-D graph adds a
DepthModality (64 points) on a depth camera with the colour camera's extrinsics, both
modalities measuring occlusions, on depth frames with a wall 0.45 m away over the
columns left of u = 70, and occlusion handling from the second frame
(n_unoccluded_iterations = 1).  Both packages' models are generated from the same body
and read the same cache file.  The trackers run frame by frame; after every step the
port's poses and histograms are held against JAX's (atol 1e-4, the tolerance of
tests/test_torch_pipeline.py), and the JAX state is then loaded into the port
(fused_serve.read_graph_state and load_graph_state), so that each step starts both from
the same state.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from m3t_tpu import camera as jcamera
from m3t_tpu import depth_modality as jdepth_modality
from m3t_tpu import detector as jdetector
from m3t_tpu import fused_serve as jfused_serve
from m3t_tpu import link as jlink
from m3t_tpu import optimizer as joptimizer
from m3t_tpu import region_modality as jregion_modality
from m3t_tpu import tracker as jtracker
from m3t_tpu.depth_model import DepthModel as JDepthModel
from m3t_tpu.region_model import RegionModel as JRegionModel
from m3t_tpu_torch import camera as tcamera
from m3t_tpu_torch import depth_modality as tdepth_modality
from m3t_tpu_torch import detector as tdetector
from m3t_tpu_torch import fused_serve as tfused_serve
from m3t_tpu_torch import link as tlink
from m3t_tpu_torch import optimizer as toptimizer
from m3t_tpu_torch import pipeline as tpipeline
from m3t_tpu_torch import region_modality as tregion_modality
from m3t_tpu_torch import tracker as ttracker
from m3t_tpu_torch.common import np_pose
from m3t_tpu_torch.depth_model import DepthModel as TDepthModel
from m3t_tpu_torch.region_model import RegionModel as TRegionModel
from m3t_tpu_torch.utils import procedural as tproc
from tests import fixtures

ATOL = 1e-4
N_FRAMES = 4
INTR = fixtures.test_intrinsics(160, 120)

PACKAGES = {
    "jax": SimpleNamespace(camera=jcamera, region=jregion_modality.RegionModality,
                           depth=jdepth_modality.DepthModality, link=jlink,
                           optimizer=joptimizer, detector=jdetector, tracker=jtracker,
                           fused=jfused_serve, kw={}),
    "torch": SimpleNamespace(camera=tcamera, region=tregion_modality.RegionModality,
                             depth=tdepth_modality.DepthModality, link=tlink,
                             optimizer=toptimizer, detector=tdetector, tracker=ttracker,
                             fused=tfused_serve, kw=dict(device="cpu")),
}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Bodies and models of both packages (the same cache files) and the frames."""
    d = tmp_path_factory.mktemp("serve")
    bodies = {"jax": fixtures.sphere_body("serve_ball", radius=0.06, n_subdiv=2),
              "torch": tproc.sphere_body("serve_ball", radius=0.06, n_subdiv=2)}
    models = {}
    for pkg, region_cls, depth_cls in (("jax", JRegionModel, JDepthModel),
                                       ("torch", TRegionModel, TDepthModel)):
        region = region_cls("serve_model", bodies[pkg], str(d / "m.npz"), n_divides=1,
                            n_points=100, image_size=400)
        depth = depth_cls("serve_dmodel", bodies[pkg], str(d / "dm.npz"), n_divides=1,
                          n_points=64, image_size=200)
        assert region.SetUp() and depth.SetUp()
        models[pkg] = (region, depth)
    rng = np.random.default_rng(19)
    frames, depth_frames = [], []
    for i in range(N_FRAMES + 2):
        pose = np_pose(translation=[0.002 * i, -0.001 * i, 0.6])
        frames.append(fixtures.render_synthetic_color_frame(bodies["jax"], INTR, pose,
                                                            noise_rng=rng))
        depth = fixtures.render_synthetic_depth_frame(bodies["jax"], INTR, pose)
        depth[:, :70] = 450
        depth_frames.append(depth)
    return dict(bodies=bodies, models=models, frames=frames, depth_frames=depth_frames)


def _graph(world, pkg, prefix, fused, rgbd=False, n_bodies=1, depth_offset=None):
    """A Tracker over n_bodies bodies of the test graph (the first is the world's body;
    the others new bodies sharing its models), on the package's classes."""
    p = PACKAGES[pkg]
    camera = p.camera.ImageColorCamera(f"{prefix}_cam", INTR, world["frames"])
    assert camera.SetUp()
    dcamera = None
    if rgbd:
        dcamera = p.camera.ImageDepthCamera(f"{prefix}_dcam", INTR, world["depth_frames"],
                                            depth_scale=0.001)
        if depth_offset is not None:
            dcamera.set_world2camera_pose(depth_offset)
        assert dcamera.SetUp()
    region_model, depth_model = world["models"][pkg]
    tracker = p.tracker.Tracker(f"{prefix}_tracker", n_corr_iterations=4,
                                n_update_iterations=2, use_fused_cycle=fused)
    modalities = []
    for i in range(n_bodies):
        body = world["bodies"][pkg]
        if i:
            body = (fixtures.sphere_body if pkg == "jax" else tproc.sphere_body)(
                f"{prefix}_ball{i}", radius=0.06, n_subdiv=2)
            assert body.SetUp()
        rm = p.region(f"{prefix}_rm{i}", body, camera, region_model, **p.kw)
        rm.n_lines_max = 100
        rm.scales = [2, 1]
        rm.standard_deviations = [5.0, 1.5]
        link = p.link.Link(f"{prefix}_link{i}", body)
        link.AddModality(rm)
        modalities.append(rm)
        if rgbd:
            dm = p.depth(f"{prefix}_dm{i}", body, dcamera, depth_model, **p.kw)
            dm.n_points_max = 64
            dm.considered_distances = [0.03, 0.02]
            dm.standard_deviations = [0.05, 0.03]
            dm.MeasureOcclusions()
            rm.MeasureOcclusions(dcamera)
            dm.n_unoccluded_iterations = rm.n_unoccluded_iterations = 1
            link.AddModality(dm)
        optimizer = p.optimizer.Optimizer(f"{prefix}_opt{i}", link)
        detector = p.detector.StaticDetector(
            f"{prefix}_det{i}", optimizer,
            link2world_pose=np_pose(translation=[0.004 - 0.002 * i, 0.001 * i, 0.6]))
        tracker.AddOptimizer(optimizer)
        tracker.AddDetector(detector)
    assert tracker.SetUp()
    return tracker, modalities


def _step(tracker, iteration):
    assert tracker.UpdateCameras(iteration)
    assert tracker.UpdateSubscribers(iteration)
    assert tracker.CalculateConsistentPoses()
    assert tracker.ExecuteDetectingStep(iteration)
    assert tracker.ExecuteStartingStep(iteration)
    assert tracker.ExecuteTrackingStep(iteration)


def _state(tracker, modalities):
    poses = np.stack([np.asarray(o.ReferencedLinks()[0].link2world_pose)
                      for o in tracker.optimizer_ptrs])
    hists = [np.stack([np.asarray(m.color_histograms_ptr.histogram_f) for m in modalities]),
             np.stack([np.asarray(m.color_histograms_ptr.histogram_b) for m in modalities])]
    return poses, hists


@pytest.mark.parametrize("rgbd", [False, True], ids=["region", "rgbd"])
@pytest.mark.parametrize("fused", [False, True], ids=["host", "fused"])
def test_tracker_matches_jax(world, fused, rgbd):
    """RunTrackerProcess's loop body, frame by frame: detection at frame 0, the starting
    step, then a tracking step per frame, on the host path or the fused backend."""
    graphs = {pkg: _graph(world, pkg, "tm", fused, rgbd) for pkg in PACKAGES}
    for tracker, _ in graphs.values():
        tracker.ExecuteDetection(start_tracking=True)
    for i in range(N_FRAMES):
        for tracker, _ in graphs.values():
            _step(tracker, i)
        (jt, jm), (tt, tm) = graphs["jax"], graphs["torch"]
        assert (jt._fused_backend is not None) == fused
        assert (tt._fused_backend is not None) == fused
        jposes, jhists = _state(jt, jm)
        tposes, thists = _state(tt, tm)
        np.testing.assert_allclose(tposes, jposes, rtol=0, atol=ATOL, err_msg=f"step {i}")
        for t, j in zip(thists, jhists):
            np.testing.assert_allclose(t, j, rtol=0, atol=ATOL, err_msg=f"step {i}")
        tfused_serve.load_graph_state(tt, tfused_serve.read_graph_state(jt))
    # The sphere was tracked (tests/test_fused_serve.py's bounds).
    truth = np_pose(translation=[0.002 * (N_FRAMES - 1), -0.001 * (N_FRAMES - 1), 0.6])
    assert np.linalg.norm(jposes[0, :2, 3] - truth[:2, 3]) < 0.004
    if rgbd:
        # The wall's measured occlusions took lines and points away.
        rm, dm = tt.optimizer_ptrs[0].ReferencedLinks()[0].modality_ptrs
        if not fused:
            assert 0 < int(rm.data_lines.valid.sum()) < 100
            assert 0 < int(dm.data_points.valid.sum()) < 64


@pytest.mark.parametrize("case", ["kinematic tree", "offset depth camera",
                                  "pinned directions"])
def test_try_build_refuses_as_jax(world, case):
    reasons = {}
    for pkg, p in PACKAGES.items():
        if case == "offset depth camera":
            tracker, _ = _graph(world, pkg, "tb", True, rgbd=True,
                                depth_offset=np_pose(translation=[-0.0525, 0.0, 0.0]))
        else:
            tracker, _ = _graph(world, pkg, "tb", True)
            link = tracker.optimizer_ptrs[0].root_link_ptr
            if case == "pinned directions":
                link.free_directions = [True] * 5 + [False]
            else:
                child = p.link.Link("tb_child", None,
                                    body2joint_pose=np_pose(translation=[0.1, 0, 0]),
                                    free_directions=[False, False, True, False, False, False])
                assert child.SetUp()
                link.AddChildLink(child)
        backend, reasons[pkg] = p.fused.FusedServeBackend.try_build(tracker)
        assert backend is None
    assert reasons["torch"] == reasons["jax"]


def test_try_build_refuses_modalities_on_several_devices(world):
    tracker, _ = _graph(world, "torch", "dv", True, n_bodies=2)
    tracker.optimizer_ptrs[1].root_link_ptr.modality_ptrs[0].device = torch.device("meta")
    backend, reason = tfused_serve.FusedServeBackend.try_build(tracker)
    assert backend is None and reason.startswith("modalities on several devices")


def test_backend_rebuilds_when_tracking_set_changes(world):
    """The cached backend is keyed on the tracking optimizer set (tests/
    test_fused_serve.py::test_fused_serve_backend_rebuilds_when_tracking_set_changes)."""
    tracker, _ = _graph(world, "torch", "rb", True, n_bodies=2)
    opt_a, opt_b = tracker.optimizer_ptrs
    tracker.ExecuteDetection(start_tracking=True, names_detecting={opt_a.name},
                             names_starting={opt_a.name})
    _step(tracker, 0)
    backend_a = tracker._fused_backend
    assert backend_a is not None and len(backend_a.optimizers) == 1
    tracker.ExecuteDetection(start_tracking=True, names_detecting={opt_b.name},
                             names_starting={opt_b.name})
    _step(tracker, 1)
    backend_ab = tracker._fused_backend
    assert backend_ab is not None and backend_ab is not backend_a
    assert len(backend_ab.optimizers) == 2
    tracker.StopTracking({opt_b.name})
    assert tracker.UpdateCameras(2) and tracker.ExecuteTrackingStep(2)
    assert len(tracker._fused_backend.optimizers) == 1
    for opt in (opt_a, opt_b):
        assert np.isfinite(opt.root_link_ptr.link2world_pose).all()


@pytest.mark.parametrize("rgbd", [False, True], ids=["region", "rgbd"])
def test_frame_is_one_upload_viewed_over_the_batch(world, rgbd, monkeypatch):
    """The backend uploads each frame once and hands the cycle a view expanded over the
    bodies (stride 0 on the batch), and every body shares one model copy."""
    seen = {}
    cycle = "tracking_cycle_rgbd" if rgbd else "tracking_cycle"
    real = getattr(tpipeline, cycle)

    def spy(*args, **kwargs):
        seen["args"] = args
        return real(*args, **kwargs)

    monkeypatch.setattr(tpipeline, cycle, spy)
    tracker, _ = _graph(world, "torch", "fv", True, rgbd=rgbd, n_bodies=3)
    tracker.ExecuteDetection(start_tracking=True)
    _step(tracker, 0)
    args = seen["args"]
    frames = args[4:6] if rgbd else args[2:3]
    for frame, image in zip(frames, (world["frames"][0], world["depth_frames"][0])):
        assert frame.shape[0] == 3 and frame.stride(0) == 0
        planar = np.moveaxis(image, -1, 0) if image.ndim == 3 else image
        np.testing.assert_array_equal(frame[2].numpy(), planar)
    model = args[6 if rgbd else 3]
    assert all(a.stride(0) == 0 for a in model)


def test_detector_link_and_optimizer_match_jax():
    """A two-link tree with a pinned child (as the serve path's host fallback sees a
    kinematic tree): StaticDetector, CalculateConsistentPoses, Jacobians, gradients and
    Hessians summed from the modalities, the Tikhonov Newton step and the pose updates."""
    rng = np.random.default_rng(5)
    root_pose = np_pose(translation=[0.01, -0.02, 0.6])
    b2j = np_pose(translation=[0.1, 0.0, 0.0])
    poses = {}
    for pkg, p in PACKAGES.items():
        terms = [SimpleNamespace(name=f"mod{i}", set_up=True,
                                 gradient=rng.normal(size=6).astype(np.float32),
                                 hessian=None) for i in range(3)]
        for term in terms:
            a = rng.normal(size=(6, 6)).astype(np.float32)
            term.hessian = -(a @ a.T) * 50.0
            if pkg == "torch":
                term.gradient, term.hessian = map(torch.as_tensor,
                                                  (term.gradient, term.hessian))
        rng = np.random.default_rng(5)  # the same terms for both packages
        parent = p.link.Link("parent")
        child = p.link.Link("child", body2joint_pose=b2j, free_directions=[
            False, False, True, True, False, False])
        parent.AddModality(terms[0])
        child.AddModality(terms[1])
        child.AddModality(terms[2])
        parent.AddChildLink(child)
        assert parent.SetUp() and child.SetUp()
        optimizer = p.optimizer.Optimizer("opt", parent, 900.0, 25000.0)
        assert optimizer.SetUp()
        detector = p.detector.StaticDetector("det", optimizer, link2world_pose=root_pose)
        assert detector.SetUp()
        found = set()
        assert detector.DetectPoses({"opt"}, found) and found == {"opt"}
        out = []
        for it in range(3):
            assert optimizer.CalculateOptimization(0, 0, it)
            out += [parent.link2world_pose, child.link2world_pose, parent.jacobian,
                    child.jacobian]
        poses[pkg] = np.concatenate([np.ravel(a) for a in out])
    np.testing.assert_allclose(poses["torch"], poses["jax"], rtol=0, atol=1e-6)


def test_serve_objects_default_to_the_card(world):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    body = world["bodies"]["torch"]
    camera = tcamera.ImageColorCamera("dc_cam", INTR, world["frames"])
    for make in (lambda: tregion_modality.RegionModality("dc", body, camera,
                                                         world["models"]["torch"][0]),
                 lambda: tdepth_modality.DepthModality("dc", body, camera,
                                                       world["models"]["torch"][1])):
        with pytest.raises(RuntimeError, match="cuda"):
            make()


@pytest.mark.parametrize("kind", ["region", "depth"])
def test_from_models_takes_the_modalities_offset_ids(world, kind):
    """The backend stacks the models with the modalities' depth-offset ids, as the JAX
    package's from_models does (the port's took id 5 whatever the radii)."""
    from m3t_tpu import pipeline as jpipeline

    index = 0 if kind == "region" else 1
    cls = "RegionModelArrays" if kind == "region" else "DepthModelArrays"
    n = 100 if kind == "region" else 64
    want = getattr(jpipeline, cls).from_models([world["models"]["jax"][index]], n,
                                               measured_offset_id=3, modeled_offset_id=7)
    got = getattr(tpipeline, cls).from_models([world["models"]["torch"][index]], n,
                                              device="cpu", measured_offset_id=3,
                                              modeled_offset_id=7)
    for name in want._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    assert not torch.equal(got.measured_depth_offsets, got.modeled_depth_offsets)


@pytest.mark.parametrize("kind", ["region", "depth"])
def test_backend_batches_the_modalities_model_copies(world, tmp_path, kind):
    """Bodies over two models, the second with 3 of the first's views: the backend's
    batch of the modalities' shared device copies equals from_models over the bodies'
    models (views zero-padded); bodies over one model share one copy, and a model's
    copy is made again after its SetUp replaced its arrays."""
    index = 0 if kind == "region" else 1
    model_cls = TRegionModel if kind == "region" else TDepthModel
    arrays_cls = tpipeline.RegionModelArrays if kind == "region" else tpipeline.DepthModelArrays
    n = 100 if kind == "region" else 64
    full = world["models"]["torch"][index]
    few = model_cls(f"few_{kind}", world["bodies"]["torch"], str(tmp_path / "few.npz"),
                    n_divides=1, n_points=n, image_size=400 if kind == "region" else 200,
                    view_subset=[0, 3, 5])
    assert few.SetUp() and few.centers.shape[0] == 3 < full.centers.shape[0]

    def copy(model):
        return tregion_modality.shared_model_arrays(arrays_cls, model, n, "cpu", 3, 7)

    copies = [copy(m) for m in (full, few, full)]
    assert copies[0] is copies[2]
    got = tfused_serve._batch_models(copies)
    want = arrays_cls.from_models([full, few, full], n, device="cpu",
                                  measured_offset_id=3, modeled_offset_id=7)
    for name in want._fields:
        torch.testing.assert_close(getattr(got, name), getattr(want, name), rtol=0,
                                   atol=0, msg=name)
    assert few.SetUp() and copy(few) is not copies[1]
