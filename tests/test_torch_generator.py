"""Parity tests: the port's generator (generator.py over utils/yaml_io) against the JAX
package's (over cv2.FileStorage), on the CPU.

One config names a class of every kind the generator builds: two bodies (a sphere and a
cube 0.1 m beside it), loader colour and depth cameras over PNGs written with cv2, a
RendererGeometry with focused depth and silhouette renderers, region and depth models,
region modalities with every scene check and shared histograms, a depth modality with
every scene check, a texture modality, two links held together by a hard and a soft
constraint, an optimizer, a static detector, a refiner, image and normal viewers and the
tracker.  Both packages build the same graph (names, classes, parameters, links,
constraints, renderers) from it, and two steps (detection, starting and tracking) give
the same state within 1e-4, each started from JAX's (fused_serve.read_graph_state and
load_graph_state: joint and link poses, histograms, texture keyframes).  Every config and metafile reads the same through the port's
YAML reader as through cv2.FileStorage.
"""

import cv2
import numpy as np
import pytest

from m3t_tpu import generator as jgenerator
from m3t_tpu.utils import yaml_io as jyaml_io
from m3t_tpu.ops.raster import rasterize_np
from m3t_tpu.utils.obj_loader import save_obj
from m3t_tpu.utils.procedural import cube, icosphere
from m3t_tpu_torch import fused_serve as tfused_serve
from m3t_tpu_torch import generator as tgenerator
from m3t_tpu_torch.common import np_pose
from m3t_tpu_torch.utils import yaml_io as tyaml_io
from tests import fixtures

INTR = fixtures.test_intrinsics(160, 120)
N_FRAMES = 3
OFFSET = 0.1  # the cube's x offset from the sphere


def ball_pose(i: int):
    return np_pose(translation=[0.002 * i, 0.0, 0.6])


def _matrix(pose) -> str:
    data = ", ".join(f"{v:g}" for v in np.asarray(pose).reshape(-1))
    return f"!!opencv-matrix\n  rows: 4\n  cols: 4\n  dt: f\n  data: [{data}]"


def _intrinsics() -> str:
    return (f"intrinsics:\n  f_u: {INTR.fu}\n  f_v: {INTR.fv}\n  pp_x: {INTR.ppu}\n"
            f"  pp_y: {INTR.ppv}\n  width: {INTR.width}\n  height: {INTR.height}\n")


FILES = {
    "ball.yaml": f"""%YAML:1.2
geometry_path: "INFER_FROM_NAME"
geometry_unit_in_meter: 1.0
geometry_counterclockwise: 1
geometry_enable_culling: 1
geometry2body_pose: {_matrix(np.eye(4))}
""",
    "box.yaml": """%YAML:1.2
geometry_path: "box.obj"
geometry_unit_in_meter: 1
geometry_counterclockwise: true
geometry_enable_culling: true
""",
    "color_camera.yaml": f"""%YAML:1.2
load_directory: "."
{_intrinsics()}image_name_pre: "color_"
load_index: 0
n_leading_zeros: 0
image_name_post: ""
load_image_type: "png"
""",
    "depth_camera.yaml": f"""%YAML:1.2
load_directory: "."
{_intrinsics()}depth_scale: 0.001
image_name_pre: "depth_"
load_index: 0
load_image_type: png
""",
    "region_model.yaml": """%YAML:1.2
model_path: "INFER_FROM_NAME"
n_divides: 1
n_points: 100
image_size: 200
""",
    "depth_model.yaml": """%YAML:1.2
model_path: "INFER_FROM_NAME"
n_divides: 1
n_points: 64
image_size: 200
""",
    "region_modality.yaml": """%YAML:1.2
n_lines: 100
scales: [2, 1]
standard_deviations: [5.0, 1.5]
n_unoccluded_iterations: 0
""",
    "depth_modality.yaml": """%YAML:1.2
n_points: 64
considered_distances: [0.03, 0.02]
standard_deviations: [0.05, 0.03]
n_unoccluded_iterations: 0
""",
    "texture_modality.yaml": """%YAML:1.2
descriptor_type: "ORB"
orb_n_features: 300
standard_deviations: [15.0, 5.0]
""",
    "box_link.yaml": f"""%YAML:1.2
joint2parent_pose: {_matrix(np_pose(translation=[OFFSET, 0, 0]))}
free_directions: [1, 1, 1, 1, 1, 1]
""",
    "constraint.yaml": f"""%YAML:1.2
body22joint2_pose: {_matrix(np_pose(translation=[OFFSET, 0, 0]))}
constraint_directions: [1, 1, 1, 0, 1, 1]
""",
    "soft_constraint.yaml": f"""%YAML:1.2
body22joint2_pose: {_matrix(np_pose(translation=[OFFSET, 0, 0]))}
constraint_directions: [0, 0, 0, 1, 0, 0]
max_distance_translation: 0.002
standard_deviation_translation: 0.002
""",
    "static_detector.yaml": f"""%YAML:1.2
link2world_pose: {_matrix(np_pose(translation=[0.003, -0.002, 0.6]))}
""",
    "viewer.yaml": """%YAML:1.2
display_images: 0
""",
    "tracker.yaml": """%YAML:1.2
n_corr_iterations: 2
n_update_iterations: 2
""",
    # tests/test_generator.py's config, read by both YAML readers only.
    "generator_test_config.yaml": """%YAML:1.2
Body:
  - name: "gen_sphere"
    metafile_path: "gen_sphere.yaml"
LoaderColorCamera:
  - name: "color_camera"
    metafile_path: "color_camera.yaml"
RegionModel:
  - name: "region_model"
    metafile_path: "region_model.yaml"
    body: "gen_sphere"
RegionModality:
  - name: "region_modality"
    metafile_path: "region_modality.yaml"
    body: "gen_sphere"
    color_camera: "color_camera"
    region_model: "region_model"
Link:
  - name: "gen_sphere_link"
    body: "gen_sphere"
    modalities: ["region_modality"]
Optimizer:
  - name: "gen_sphere_optimizer"
    root_link: "gen_sphere_link"
StaticDetector:
  - name: "detector"
    metafile_path: "static_detector.yaml"
    optimizer: "gen_sphere_optimizer"
Tracker:
  - name: "tracker"
    optimizers: ["gen_sphere_optimizer"]
    detectors: ["detector"]
""",
    "config.yaml": """%YAML:1.2
---
Body:
  - name: "ball"
    metafile_path: "ball.yaml"
  - {name: box, metafile_path: box.yaml}
ColorHistograms:
  - name: "shared_histograms"
RendererGeometry:
  - name: "rg"
    bodies: ["ball", "box"]
LoaderColorCamera:
  - name: "color_camera"
    metafile_path: "color_camera.yaml"
LoaderDepthCamera:
  - name: "depth_camera"
    metafile_path: "depth_camera.yaml"
FocusedBasicDepthRenderer:
  - name: "depth_renderer"
    renderer_geometry: "rg"
    camera: "color_camera"
    referenced_bodies: ["ball"]
FocusedSilhouetteRenderer:
  - name: "region_renderer"
    renderer_geometry: "rg"
    camera: "color_camera"
    id_type: "region"
    referenced_bodies: ["ball"]
  - name: "body_renderer"
    renderer_geometry: "rg"
    camera: "color_camera"
    referenced_bodies: ["ball"]
RegionModel:
  - name: "ball_region_model"
    metafile_path: "region_model.yaml"
    body: "ball"
  - name: "box_region_model"
    metafile_path: "region_model.yaml"
    body: "box"
DepthModel:
  - name: "ball_depth_model"
    metafile_path: "depth_model.yaml"
    body: "ball"
RegionModality:
  - name: "ball_region"
    metafile_path: "region_modality.yaml"
    body: "ball"
    color_camera: "color_camera"
    region_model: "ball_region_model"
    measure_occlusions: {depth_camera: "depth_camera"}
    model_occlusions:
      focused_depth_renderer: "depth_renderer"
    use_region_checking:
      focused_silhouette_renderer: "region_renderer"
  - name: "box_region"
    metafile_path: "region_modality.yaml"
    body: "box"
    color_camera: "color_camera"
    region_model: "box_region_model"
    use_shared_color_histograms: {color_histograms: shared_histograms}
DepthModality:
  - name: "ball_depth"
    metafile_path: "depth_modality.yaml"
    body: "ball"
    depth_camera: "depth_camera"
    depth_model: "ball_depth_model"
    measure_occlusions: 1
    model_occlusions: {focused_depth_renderer: "depth_renderer"}
    use_silhouette_checking: {focused_silhouette_renderer: "body_renderer"}
TextureModality:
  - name: "ball_texture"
    metafile_path: "texture_modality.yaml"
    body: "ball"
    color_camera: "color_camera"
    focused_silhouette_renderer: "body_renderer"
Link:
  - name: "ball_link"
    body: "ball"
    modalities: ["ball_region", "ball_depth", "ball_texture"]
    child_links: ["box_link"]
  - name: "box_link"
    body: "box"
    metafile_path: "box_link.yaml"
    modalities: ["box_region"]
Constraint:
  - name: "hinge"
    metafile_path: "constraint.yaml"
    link1: "ball_link"
    link2: "box_link"
SoftConstraint:
  - name: "slide"
    metafile_path: "soft_constraint.yaml"
    link1: "ball_link"
    link2: "box_link"
Optimizer:
  - name: "optimizer"
    root_link: "ball_link"
    constraints: ["hinge"]
    soft_constraints: ["slide"]
StaticDetector:
  - name: "detector"
    metafile_path: "static_detector.yaml"
    optimizer: "optimizer"
Refiner:
  - name: "refiner"
    optimizers: ["optimizer"]
ImageColorViewer:
  - name: "color_viewer"
    metafile_path: "viewer.yaml"
    color_camera: "color_camera"
NormalDepthViewer:
  - name: "normal_viewer"
    metafile_path: "viewer.yaml"
    depth_camera: "depth_camera"
    renderer_geometry: "rg"
Tracker:
  - name: "tracker"
    metafile_path: "tracker.yaml"
    optimizers: ["optimizer"]
    detectors: ["detector"]
    refiners: ["refiner"]
    viewers: ["color_viewer", "normal_viewer"]
""",
}


def _one_link(config: str) -> str:
    """config.yaml with the ball's link alone: no cube link and no constraints."""
    head, tail = config.split("\nConstraint:\n")
    config = head + "\n" + tail[tail.index("Optimizer:\n"):]
    for cut in ('    child_links: ["box_link"]\n',
                '  - name: "box_link"\n    body: "box"\n    metafile_path: "box_link.yaml"\n'
                '    modalities: ["box_region"]\n',
                '    constraints: ["hinge"]\n    soft_constraints: ["slide"]\n'):
        assert cut in config
        config = config.replace(cut, "")
    return config


FILES["one_link.yaml"] = _one_link(FILES["config.yaml"])


@pytest.fixture(scope="module")
def config_dir(tmp_path_factory):
    """The config, its metafiles, the meshes and the PNG frames (colour and 16-bit
    depth, 0 where nothing is) of the sphere and the cube moving 2 mm along x per
    frame."""
    d = tmp_path_factory.mktemp("gen")
    for name, text in FILES.items():
        (d / name).write_text(text)
    save_obj(str(d / "ball.obj"), *icosphere(2, 0.05))
    save_obj(str(d / "box.obj"), *cube(0.03))
    ball = fixtures.sphere_body("gen_frames_ball", radius=0.05, n_subdiv=2)
    box = fixtures.cube_body("gen_frames_box", half=0.03)
    rng = np.random.default_rng(13)
    # A colour per face of the sphere (keypoints for the texture modality), the cube
    # green, on a dark background.
    colours = np.concatenate([rng.integers(40, 255, (len(ball.triangles), 3)),
                              np.tile([60, 170, 60], (len(box.triangles), 1))])
    for i in range(N_FRAMES + 1):
        poses = [ball_pose(i), ball_pose(i) @ np_pose(translation=[OFFSET, 0, 0])]
        tri = np.concatenate([b.triangle_vertices_f_body() @ p[:3, :3].T + p[:3, 3]
                              for b, p in zip([ball, box], poses)])
        depth, ids = rasterize_np(tri, np.arange(1, len(tri) + 1), INTR.fu, INTR.fv,
                                  INTR.ppu, INTR.ppv, INTR.width, INTR.height,
                                  cull_backfaces=True)
        image = np.full((INTR.height, INTR.width, 3), 30, np.int16)
        image[ids > 0] = colours[ids[ids > 0] - 1]
        image += rng.integers(-5, 6, image.shape).astype(np.int16)
        cv2.imwrite(str(d / f"color_{i}.png"), np.clip(image, 0, 255).astype(np.uint8))
        cv2.imwrite(str(d / f"depth_{i}.png"),
                    np.round(np.where(np.isfinite(depth), depth, 0.0) / 0.001).astype(np.uint16))
    return d


def test_yaml_io_reads_configs_as_cv2(config_dir):
    """Every file of this test and tests/test_generator.py's config through both
    readers: the port's dict equals cv2.FileStorage's nodes (opencv matrices as arrays
    of their dt, maps, flow and block sequences, quoted and plain scalars, booleans)."""
    for path in sorted(config_dir.glob("*.yaml")):
        fs = cv2.FileStorage(str(path), cv2.FILE_STORAGE_READ)
        root = fs.root()
        want = {k: jyaml_io._node_to_python(root.getNode(k)) for k in root.keys()}
        fs.release()
        got = tyaml_io.open_yaml_file_storage(str(path))
        assert got.keys() == want.keys(), path.name
        _assert_same(got, want, path.name)


def _assert_same(got, want, where):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), where
        for k in want:
            _assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


def _parameters(obj) -> dict:
    """An object's public parameters: numbers, strings and lists of them, poses."""
    out = {}
    for key, value in vars(obj).items():
        if key.startswith("_") or key in ("device", "set_up"):
            continue
        if isinstance(value, (bool, int, float, str)) or (
                isinstance(value, list) and all(isinstance(v, (bool, int, float))
                                                for v in value)):
            out[key] = value
        elif isinstance(value, np.ndarray) and value.shape == (4, 4):
            out[key] = value.tolist()
    return out


def _graph(tracker) -> dict:
    """Names, classes, parameters and references of everything the tracker holds."""
    out = {"tracker": _parameters(tracker)}
    for opt in tracker.optimizer_ptrs:
        out[opt.name] = (type(opt).__name__, _parameters(opt))
        for c in opt.constraint_ptrs + opt.soft_constraint_ptrs:
            out[c.name] = (type(c).__name__, c.link1_ptr.name, c.link2_ptr.name,
                           _parameters(c))
        for link in opt.ReferencedLinks():
            out[link.name] = (_parameters(link), link.body_ptr.name,
                              [c.name for c in link.child_link_ptrs])
            for m in link.modality_ptrs:
                refs = {k: getattr(v, "name", None) for k, v in vars(m).items()
                        if k.endswith("_ptr") and v is not None}
                out[m.name] = (type(m).__name__, refs, _parameters(m))
                for r in m.start_modality_renderer_ptrs():
                    out[r.name] = (type(r).__name__, r.id_type.name if hasattr(
                        r, "id_type") else None, r.image_size,
                        [b.name for b in r.referenced_body_ptrs],
                        r.renderer_geometry_ptr.name)
    for group in ("detector_ptrs", "refiner_ptrs", "viewer_ptrs", "body_ptrs",
                  "camera_ptrs", "renderer_geometry_ptrs"):
        out[group] = sorted((o.name, type(o).__name__) for o in getattr(tracker, group))
    return out


def test_generated_graphs_match_jax_and_track(config_dir):
    trackers = {"jax": jgenerator.GenerateConfiguredTracker(str(config_dir / "config.yaml")),
                "torch": tgenerator.GenerateConfiguredTracker(
                    str(config_dir / "config.yaml"), device="cpu")}
    for tracker in trackers.values():
        assert tracker.SetUp()
    graphs = {pkg: _graph(t) for pkg, t in trackers.items()}
    assert graphs["torch"] == graphs["jax"]
    assert graphs["torch"]["hinge"][3]["constraint_directions"] == [True, True, True,
                                                                   False, True, True]
    assert len(graphs["torch"]["viewer_ptrs"]) == 2
    for tracker in trackers.values():
        tracker.ExecuteDetection(start_tracking=True)
        # Without the refiner's Newton steps from the detected pose: on these two links
        # they are chaotic (test_refiner_matches_jax), so they would compare nothing.
        tracker.detecting_refiner_ptrs = []
    for i in range(2):
        for tracker in trackers.values():
            assert tracker.UpdateCameras(i) and tracker.CalculateConsistentPoses()
            assert tracker.ExecuteDetectingStep(i) and tracker.ExecuteStartingStep(i)
            assert tracker.ExecuteTrackingStep(i) and tracker.UpdateViewers(i)
        state = {pkg: tfused_serve.read_graph_state(t) for pkg, t in trackers.items()}
        _assert_state_close(state["torch"], state["jax"], f"step {i}")
        # The next step of the port starts from JAX's state (joint and link poses,
        # histograms, texture keyframes), so a step's mismatch shows as its own.
        tfused_serve.load_graph_state(trackers["torch"], state["jax"])
        _assert_state_close(tfused_serve.read_graph_state(trackers["torch"]), state["jax"],
                            f"loaded state {i}", atol=0)
    assert state["torch"]["keyframes"]["ball_texture"]["points"][0].shape[0] > 5
    ball = state["torch"]["links"]["ball_link"][2]
    assert np.abs(ball[:3, 3] - ball_pose(1)[:3, 3]).max() < 0.004


def _refined(config_dir, pkg, config, n_corr_iterations=None, nudge=0.0):
    """read_graph_state after the detecting step of frame 0 (the static detector, then
    the refiner: StartModality before each of its correspondence iterations), the
    refiner's correspondence iterations cut to n_corr_iterations where given and the
    detected translation moved by a relative ``nudge``."""
    path = str(config_dir / config)
    tracker = (jgenerator.GenerateConfiguredTracker(path) if pkg == "jax"
               else tgenerator.GenerateConfiguredTracker(path, device="cpu"))
    assert tracker.SetUp()
    if n_corr_iterations is not None:
        tracker.refiner_ptrs[0].n_corr_iterations = n_corr_iterations
    detector = tracker.detector_ptrs[0]
    pose = np.array(detector.link2world_pose, np.float32)
    pose[:3, 3] *= np.float32(1.0 + nudge)
    detector.link2world_pose = pose
    tracker.ExecuteDetection(start_tracking=True)
    assert tracker.UpdateCameras(0) and tracker.CalculateConsistentPoses()
    assert tracker.ExecuteDetectingStep(0)
    return tfused_serve.read_graph_state(tracker)


def _largest_pose_difference(a, b) -> float:
    return max(float(np.abs(a["links"][n][2] - b["links"][n][2]).max()) for n in b["links"])


@pytest.mark.parametrize("config,n_corr_iterations", [
    ("one_link.yaml", None), ("config.yaml", 1), ("config.yaml", None)],
    ids=["one link", "two links, first iteration", "two links"])
def test_refiner_matches_jax(config_dir, config, n_corr_iterations):
    """The generated refiner (3x3 iterations) from the static detector's pose in both
    packages.  The ball's link alone, and the two links held by the hinge and the slide
    through the refiner's first correspondence iteration: refined poses within 1e-4.
    Through all three iterations the two links' refinement is chaotic: a relative 1e-6
    move of the detected translation moves JAX's own refined pose by more than 1 mm (in
    the first iteration by less than 1e-4), so there the port is held within twice that
    spread of JAX's pose; this is why test_generated_graphs_match_jax_and_track steps
    without the refiner."""
    got, want = (_refined(config_dir, pkg, config, n_corr_iterations)
                 for pkg in ("torch", "jax"))
    assert got["links"].keys() == want["links"].keys()
    gap = _largest_pose_difference(got, want)
    if n_corr_iterations is None and config == "config.yaml":
        spread = _largest_pose_difference(
            _refined(config_dir, "jax", config, n_corr_iterations, nudge=1e-6), want)
        assert spread > 1e-3 and gap < 2 * spread, (gap, spread)
    else:
        assert gap < 1e-4, gap
    ball = got["links"]["ball_link"][2]
    assert np.abs(ball[:3, 3] - ball_pose(0)[:3, 3]).max() < 0.004


def _assert_state_close(got, want, where, atol=1e-4):
    """read_graph_state results: the same names, poses and histograms within atol, the
    texture keyframes' descriptors and keypoints equal and their points within 1e-6 m
    (they unproject rendered depth, see tests/test_torch_texture_modality.py)."""
    for group in ("links", "histograms"):
        assert got[group].keys() == want[group].keys()
        for name in want[group]:
            for g, w in zip(got[group][name], want[group][name]):
                np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{where} {name}")
    assert got["keyframes"].keys() == want["keyframes"].keys()
    for name, w in want["keyframes"].items():
        g = got["keyframes"][name]
        assert g["age"] == w["age"] and len(g["points"]) == len(w["points"])
        pairs = [(a, b, 1e-6) for a, b in zip(g["points"], w["points"])]
        pairs += [(a, b, 0) for a, b in zip(g["descriptors"], w["descriptors"])]
        pairs += [(g[k], w[k], 1e-6) for k in ("keypoints", "descriptors_now", "orientation")]
        for a, b, tol in pairs:
            assert (a is None) == (b is None)
            if b is not None:
                np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def test_generator_rejects_missing_reference(tmp_path):
    """Twin of tests/test_generator.py::test_generator_rejects_missing_reference."""
    (tmp_path / "bad.yaml").write_text("""%YAML:1.2
Body:
  - name: "b"
    metafile_path: "missing_body.yaml"
Tracker:
  - name: "t"
    optimizers: ["nonexistent"]
""")
    for module in (jgenerator, tgenerator):
        with pytest.raises(module.GeneratorError, match="nonexistent"):
            module.GenerateConfiguredTracker(str(tmp_path / "bad.yaml"),
                                             *(() if module is jgenerator else ("cpu",)))


@pytest.mark.parametrize("config,message", [
    ("Tracker:\n  - name: a\n    optimizers: []\n  - name: b\n    optimizers: []\n",
     "More than one tracker"),
    ("Body:\n  - name: b\n    metafile_path: b.yaml\n", "No tracker was configured"),
    ("Body:\n  - name: b\nTracker:\n  - name: t\n    optimizers: []\n",
     'Required parameter "metafile_path" was not configured for Body'),
])
def test_generator_errors_match_jax(tmp_path, config, message):
    (tmp_path / "c.yaml").write_text("%YAML:1.2\n---\n" + config)
    errors = []
    for module in (jgenerator, tgenerator):
        with pytest.raises(module.GeneratorError) as error:
            module.GenerateConfiguredTracker(str(tmp_path / "c.yaml"),
                                             *(() if module is jgenerator else ("cpu",)))
        errors.append(str(error.value))
    assert errors[0] == errors[1] and message in errors[1]
