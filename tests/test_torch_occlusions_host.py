"""Parity tests: the host path's scene checks of the port's modalities (modeled
occlusions through a FocusedBasicDepthRenderer, region checking and silhouette checking
through a FocusedSilhouetteRenderer) against the JAX package's, on the CPU.

The scene is tests/test_occlusions.py's: a tracked sphere (radius 0.06 m) 0.7 m from a
200x150 camera and an untracked cube (half size 0.05 m) 0.5 m away over its left half,
in the RendererGeometry of both packages; the bodies' ids are set explicitly on both
sides.  Both packages' region and depth models read one cache file.  The four cases of
tests/test_occlusions.py compare the valid lines line by line; the Tracker case runs the
sphere moving 1 mm per frame through RunTrackerProcess's loop body with every scene
check on, holds poses and histograms within 1e-4 after each step and then starts the
next step of the port from JAX's state (fused_serve.read_graph_state and
load_graph_state).
"""

from types import SimpleNamespace

import numpy as np
import pytest

from m3t_tpu import camera as jcamera
from m3t_tpu import constraint as jconstraint
from m3t_tpu import depth_modality as jdepth_modality
from m3t_tpu import detector as jdetector
from m3t_tpu import fused_serve as jfused_serve
from m3t_tpu import link as jlink
from m3t_tpu import optimizer as joptimizer
from m3t_tpu import region_modality as jregion_modality
from m3t_tpu import renderer as jrenderer
from m3t_tpu import renderer_geometry as jrenderer_geometry
from m3t_tpu import tracker as jtracker
from m3t_tpu.depth_model import DepthModel as JDepthModel
from m3t_tpu.ops.raster import rasterize_np
from m3t_tpu.region_model import RegionModel as JRegionModel
from m3t_tpu_torch import camera as tcamera
from m3t_tpu_torch import constraint as tconstraint
from m3t_tpu_torch import depth_modality as tdepth_modality
from m3t_tpu_torch import detector as tdetector
from m3t_tpu_torch import fused_serve as tfused_serve
from m3t_tpu_torch import link as tlink
from m3t_tpu_torch import optimizer as toptimizer
from m3t_tpu_torch import region_modality as tregion_modality
from m3t_tpu_torch import renderer as trenderer
from m3t_tpu_torch import renderer_geometry as trenderer_geometry
from m3t_tpu_torch import tracker as ttracker
from m3t_tpu_torch.common import np_pose
from m3t_tpu_torch.depth_model import DepthModel as TDepthModel
from m3t_tpu_torch.region_model import RegionModel as TRegionModel
from m3t_tpu_torch.utils import procedural as tproc
from tests import fixtures

ATOL = 1e-4
N_FRAMES = 3
INTR = fixtures.test_intrinsics(200, 150)
CUBE_POSE = np_pose(translation=[-0.05, 0.0, 0.5])
IDS = {"sphere": (21, 5), "cube": (22, 6)}  # (body id, region id)

PACKAGES = {
    "jax": SimpleNamespace(
        camera=jcamera, region=jregion_modality.RegionModality,
        depth=jdepth_modality.DepthModality, link=jlink, optimizer=joptimizer,
        detector=jdetector, tracker=jtracker, fused=jfused_serve, renderer=jrenderer,
        geometry=jrenderer_geometry.RendererGeometry, constraint=jconstraint.Constraint,
        make=fixtures, models=(JRegionModel, JDepthModel), kw={}),
    "torch": SimpleNamespace(
        camera=tcamera, region=tregion_modality.RegionModality,
        depth=tdepth_modality.DepthModality, link=tlink, optimizer=toptimizer,
        detector=tdetector, tracker=ttracker, fused=tfused_serve, renderer=trenderer,
        geometry=trenderer_geometry.RendererGeometry, constraint=tconstraint.Constraint,
        make=tproc, models=(TRegionModel, TDepthModel), kw=dict(device="cpu")),
}


def sphere_pose(frame: int):
    return np_pose(translation=[0.001 * frame, 0.0, 0.7])


def _frames():
    """Colour and uint16 depth frames of the sphere (moving 1 mm per frame) behind the
    cube, rendered once on the host."""
    sphere = fixtures.sphere_body("ohf_sphere", radius=0.06, n_subdiv=2)
    cube = fixtures.cube_body("ohf_cube", half=0.05)
    colours, depths = [], []
    for i in range(N_FRAMES + 1):
        verts, ids = [], []
        for k, (body, pose) in enumerate([(sphere, sphere_pose(i)), (cube, CUBE_POSE)]):
            tri = body.triangle_vertices_f_body()
            verts.append(tri @ pose[:3, :3].T + pose[:3, 3])
            ids.append(np.full(len(tri), k + 1))
        depth, id_img = rasterize_np(np.concatenate(verts), np.concatenate(ids), INTR.fu,
                                     INTR.fv, INTR.ppu, INTR.ppv, INTR.width, INTR.height,
                                     cull_backfaces=True)
        image = np.empty((INTR.height, INTR.width, 3), np.uint8)
        image[:] = [40, 120, 190]
        image[id_img == 1] = [160, 60, 50]
        image[id_img == 2] = [60, 170, 60]
        noise = np.random.default_rng(i).integers(-6, 7, image.shape)
        colours.append(np.clip(image.astype(np.int16) + noise, 0, 255).astype(np.uint8))
        depths.append(np.round(np.where(np.isfinite(depth), depth, 2.0) / 0.001
                               ).astype(np.uint16))
    return colours, depths


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    d = tmp_path_factory.mktemp("occl_host")
    colours, depths = _frames()
    out = dict(colours=colours, depths=depths)
    for pkg, p in PACKAGES.items():
        sphere = p.make.sphere_body("oh_sphere", radius=0.06, n_subdiv=2)
        cube = p.make.cube_body("oh_cube", half=0.05)
        for body, (bid, rid) in zip((sphere, cube), IDS.values()):
            body.body_id, body.region_id = bid, rid
        sphere.set_body2world_pose(sphere_pose(0))
        cube.set_body2world_pose(CUBE_POSE)
        region_cls, depth_cls = p.models
        region = region_cls("oh_model", sphere, str(d / "m.npz"), n_divides=1,
                            n_points=150, image_size=200)
        depth = depth_cls("oh_dmodel", sphere, str(d / "dm.npz"), n_divides=1,
                          n_points=64, image_size=200)
        assert region.SetUp() and depth.SetUp()
        out[pkg] = dict(sphere=sphere, cube=cube, region_model=region, depth_model=depth)
    return out


def _scene(world, pkg, prefix):
    """Cameras over the frames, the RendererGeometry of both bodies and the focused
    renderers (depth, region silhouette, body silhouette) referencing the sphere."""
    p, w = PACKAGES[pkg], world[pkg]
    color_camera = p.camera.ImageColorCamera(f"{prefix}_cam", INTR, world["colours"])
    depth_camera = p.camera.ImageDepthCamera(f"{prefix}_dcam", INTR, world["depths"],
                                             depth_scale=0.001)
    assert color_camera.SetUp() and depth_camera.SetUp()
    rg = p.geometry(f"{prefix}_rg", **p.kw)
    assert rg.AddBody(w["sphere"]) and rg.AddBody(w["cube"]) and rg.SetUp()
    renderers = dict(
        depth=p.renderer.FocusedBasicDepthRenderer(f"{prefix}_dr", rg, color_camera, **p.kw),
        region=p.renderer.FocusedSilhouetteRenderer(
            f"{prefix}_rs", rg, color_camera, id_type=p.renderer.IDType.REGION, **p.kw),
        body=p.renderer.FocusedSilhouetteRenderer(
            f"{prefix}_bs", rg, color_camera, id_type=p.renderer.IDType.BODY, **p.kw))
    for r in renderers.values():
        assert r.AddReferencedBody(w["sphere"]) and r.SetUp()
    return SimpleNamespace(color_camera=color_camera, depth_camera=depth_camera, rg=rg,
                           **renderers)


def _region_modality(world, pkg, scene, name, flags):
    """tests/test_occlusions.py's _make_modality on the package's classes."""
    p, w = PACKAGES[pkg], world[pkg]
    modality = p.region(name, w["sphere"], scene.color_camera, w["region_model"], **p.kw)
    modality.n_lines_max = 150
    modality.scales = [2, 1]
    modality.standard_deviations = [5.0, 1.5]
    modality.n_unoccluded_iterations = 0
    if "model" in flags:
        modality.ModelOcclusions(scene.depth)
    if "measure" in flags:
        modality.MeasureOcclusions(scene.depth_camera)
    if "region" in flags:
        modality.UseRegionChecking(scene.region)
    return modality


@pytest.mark.parametrize("case", ["modeled", "measured", "region checking",
                                  "unoccluded fallback"])
def test_scene_check_cases_match_jax(world, case):
    """The four cases of tests/test_occlusions.py: the lines each check leaves valid, in
    both packages, against the same lines without the check."""
    flags = {"modeled": ("model",), "measured": ("measure",),
             "region checking": ("region",), "unoccluded fallback": ("model",)}[case]
    valid, counts = {}, {}
    for pkg in PACKAGES:
        scene = _scene(world, pkg, f"c{pkg}")
        assert scene.color_camera.UpdateImage() and scene.depth_camera.UpdateImage()
        assert scene.depth.StartRendering() and scene.region.StartRendering()
        out = []
        for mod_flags in ((), flags):
            modality = _region_modality(world, pkg, scene, f"c_{pkg}_{len(mod_flags)}",
                                        mod_flags)
            assert modality.SetUp() and modality.StartModality(0, 0)
            assert modality.CalculateCorrespondences(0, 0)
            out.append(np.asarray(modality.data_lines.valid).reshape(-1))
            if case == "unoccluded fallback" and mod_flags:
                n_with = int(out[-1].sum())
                modality.min_n_unoccluded_lines = n_with + 20
                modality._cfg = modality._cfg._replace(min_n_unoccluded_lines=n_with + 20)
                assert modality.CalculateCorrespondences(0, 0)
                out.append(np.asarray(modality.data_lines.valid).reshape(-1))
        valid[pkg] = out
        counts[pkg] = [int(v.sum()) for v in out]
    assert counts["torch"] == counts["jax"]
    for got, want in zip(valid["torch"], valid["jax"]):
        np.testing.assert_array_equal(got, want)
    baseline, checked = counts["torch"][:2]
    assert 10 < checked < baseline * (1.0 if case == "region checking" else 0.85)
    if case == "unoccluded fallback":
        assert counts["torch"][2] == baseline


def _tracker(world, pkg, prefix, with_depth=True):
    """The sphere with a RegionModality (measured and modeled occlusions, region
    checking) and a DepthModality (measured and modeled occlusions, silhouette
    checking) on the focused renderers, a StaticDetector 3 mm off, 3x2 iterations."""
    p, w = PACKAGES[pkg], world[pkg]
    scene = _scene(world, pkg, prefix)
    rm = _region_modality(world, pkg, scene, f"{prefix}_rm", ("model", "measure", "region"))
    link = p.link.Link(f"{prefix}_link", w["sphere"])
    link.AddModality(rm)
    if with_depth:
        dm = p.depth(f"{prefix}_dm", w["sphere"], scene.depth_camera, w["depth_model"],
                     **p.kw)
        dm.n_points_max = 64
        dm.considered_distances = [0.03, 0.02]
        dm.standard_deviations = [0.05, 0.03]
        dm.n_unoccluded_iterations = 0
        dm.MeasureOcclusions()
        dm.ModelOcclusions(scene.depth)
        dm.UseSilhouetteChecking(scene.body)
        link.AddModality(dm)
    optimizer = p.optimizer.Optimizer(f"{prefix}_opt", link)
    tracker = p.tracker.Tracker(f"{prefix}_tracker", n_corr_iterations=3,
                                n_update_iterations=2, use_fused_cycle=True)
    tracker.AddOptimizer(optimizer)
    tracker.AddDetector(p.detector.StaticDetector(
        f"{prefix}_det", optimizer, link2world_pose=np_pose(translation=[0.003, -0.002,
                                                                         0.7])))
    assert tracker.SetUp()
    return tracker, rm


def _step(tracker, iteration):
    assert tracker.UpdateCameras(iteration)
    assert tracker.CalculateConsistentPoses()
    assert tracker.ExecuteDetectingStep(iteration)
    assert tracker.ExecuteStartingStep(iteration)
    assert tracker.ExecuteTrackingStep(iteration)


def test_tracker_with_scene_checks_matches_jax(world):
    graphs = {pkg: _tracker(world, pkg, "tr") for pkg in PACKAGES}
    for tracker, _ in graphs.values():
        tracker.ExecuteDetection(start_tracking=True)
    for i in range(N_FRAMES):
        for tracker, _ in graphs.values():
            _step(tracker, i)
            # The graph models occlusions: the fused backend refused it.
            assert tracker._fused_backend is None
        state = {}
        for pkg, (tracker, rm) in graphs.items():
            hist = rm.color_histograms_ptr
            state[pkg] = (tracker.optimizer_ptrs[0].root_link_ptr.link2world_pose[None],
                          np.asarray(hist.histogram_f)[None],
                          np.asarray(hist.histogram_b)[None])
        for got, want in zip(state["torch"], state["jax"]):
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=f"step {i}")
        tfused_serve.load_graph_state(graphs["torch"][0],
                                      tfused_serve.read_graph_state(graphs["jax"][0]))
    error = np.abs(state["torch"][0][0, :3, 3] - sphere_pose(N_FRAMES - 1)[:3, 3]).max()
    assert error < 0.003
    # The checks took lines and points away on the port's side.
    rm = graphs["torch"][1]
    dm = graphs["torch"][0].optimizer_ptrs[0].root_link_ptr.modality_ptrs[1]
    assert 10 < int(rm.data_lines.valid.sum()) < 150
    assert 5 < int(dm.data_points.valid.sum()) < 64


@pytest.mark.parametrize("case", ["model occlusions", "region checking",
                                  "silhouette checking", "constraint"])
def test_try_build_refuses_scene_checks_as_jax(world, case):
    reasons = {}
    for pkg, p in PACKAGES.items():
        tracker, rm = _tracker(world, pkg, "rb", with_depth=(case == "silhouette checking"))
        link = tracker.optimizer_ptrs[0].root_link_ptr
        dm = link.modality_ptrs[1] if len(link.modality_ptrs) > 1 else None
        rm.model_occlusions = case == "model occlusions"
        rm.use_region_checking = case == "region checking"
        if dm is not None:
            dm.model_occlusions = False
        if case == "constraint":
            child = p.link.Link("rb_child", None,
                                body2joint_pose=np_pose(translation=[0.1, 0, 0]))
            assert child.SetUp()
            constraint = p.constraint("rb_constraint", link, child)
            assert constraint.SetUp()
            tracker.optimizer_ptrs[0].AddConstraint(constraint)
        backend, reasons[pkg] = p.fused.FusedServeBackend.try_build(tracker)
        assert backend is None
    assert reasons["torch"] == reasons["jax"]
    assert {"model occlusions": "models occlusions", "region checking": "region checking",
            "silhouette checking": "checks silhouettes",
            "constraint": "has constraints"}[case] in reasons["torch"]
