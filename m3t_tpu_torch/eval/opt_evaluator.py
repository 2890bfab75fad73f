"""OPT dataset evaluator (port of m3t_tpu/eval/opt_evaluator.py; reference
M3T/examples/opt_evaluator.{h,cpp}).

RGB-D tracking on the OPT benchmark; the metric is the AUC of the tracking-success vs
error-threshold curve, with thresholds scaled by the body diameter
(opt_evaluator.cpp:462-484; AUC definition opt_evaluator.h:80,150).

Two dataset layouts are supported:
  * The published OPT layout (opt_evaluator.cpp:246-262, 602-630): run configurations
    are the product body x orientation {b,f,l,r} x motion pattern {tr_*, zo_*, ir_*,
    or_*, fl, ml, fm}; sequences live at ``3D/<seq>/color|depth`` with
    ``<seq> = <body[:2]>_<pattern>_<orientation>``, and GT poses at
    ``3D/poses/<seq>.txt`` with 12 column-major values per line, post-multiplied by
    the inverse per-body geometry2body pose.
  * A generic layout for synthetic mini datasets (``sequence_names`` +
    ``3D/<seq>/<body>.txt`` with row-major "r11 ... r33 tx ty tz" rows).

The modalities hold their tensors on ``device`` (the card unless the caller asks for
the CPU); the tracker serves through the fused cycle where the graph allows it.
"""

from __future__ import annotations

import os

import numpy as np

from m3t_tpu_torch.body import Body
from m3t_tpu_torch.camera import LoaderColorCamera, LoaderDepthCamera
from m3t_tpu_torch.common import Intrinsics, resolve_device
from m3t_tpu_torch.depth_modality import DepthModality
from m3t_tpu_torch.depth_model import DepthModel
from m3t_tpu_torch.detector import StaticDetector
from m3t_tpu_torch.eval import metrics
from m3t_tpu_torch.link import Link
from m3t_tpu_torch.optimizer import Optimizer
from m3t_tpu_torch.region_modality import RegionModality
from m3t_tpu_torch.region_model import RegionModel
from m3t_tpu_torch.renderer_geometry import RendererGeometry
from m3t_tpu_torch.tracker import Tracker

OPT_INTRINSICS = Intrinsics(1060.197, 1060.273, 964.809, 560.952, 1920, 1080)
N_CURVE_VALUES = 100
THRESHOLD_MAX = 0.2

# Depth-to-color extrinsics (opt_evaluator.h kDepth2Color_Pose).  NOTE: the
# reference feeds this row-major float array into a column-major Eigen::Matrix4f,
# which transposes the rotation and drops the translation from the affine part —
# the -5.25 cm x-baseline clearly intended by the constant is lost.  We apply the
# intended row-major reading; the deviation is recorded in PARITY.md.
DEPTH2COLOR_POSE = np.array(
    [[0.9999788893, -0.0052817802, 0.0037846718, -0.0525133559],
     [0.0052971168, 0.9999777534, -0.0040537989, 0.0006022050],
     [-0.0037631764, 0.0040737612, 0.9999846214, -0.0003262078],
     [0.0, 0.0, 0.0, 1.0]], np.float32)

# Per-body geometry2body translations (opt_evaluator.h kBody2Geometry2BodyPoseMap).
BODY2GEOMETRY2BODY_TRANSLATION = {
    "soda": (0.0006, -0.0004, -0.0549),
    "chest": (-0.0002, -0.0009, -0.0377),
    "ironman": (0.0023, 0.0005, -0.0506),
    "house": (-0.0008, -0.0059, -0.0271),
    "bike": (-0.0018, 0.0001, -0.0267),
    "jet": (-0.0004, 0.0001, -0.0117),
}

# Precomputed maximum body diameters (opt_evaluator.h kBody2PrecomputedDiametersMap).
BODY2PRECOMPUTED_DIAMETER = {
    "soda": 0.121923, "chest": 0.122367, "ironman": 0.101993,
    "house": 0.12937, "bike": 0.120494, "jet": 0.112384,
}

BODY_ORIENTATIONS = ["b", "f", "l", "r"]
MOTION_PATTERNS = ["tr_1", "tr_2", "tr_3", "tr_4", "tr_5", "zo_1", "zo_2",
                   "zo_3", "zo_4", "zo_5", "ir_1", "ir_2", "ir_3", "ir_4",
                   "ir_5", "or_1", "or_2", "or_3", "or_4", "or_5",
                   "fl", "ml", "fm"]


def read_matrix_poses(path: str) -> np.ndarray:
    """Generic rows of 9 row-major rotation + 3 translation values."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 12)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
    poses[:, :3, :3] = rows[:, :9].reshape(-1, 3, 3).astype(np.float32)
    poses[:, :3, 3] = rows[:, 9:12].astype(np.float32)
    return poses


def read_opt_gt_poses(path: str, geometry2body_pose: np.ndarray) -> np.ndarray:
    """OPT GT format: 12 COLUMN-major values per line (opt_evaluator.cpp:616-627),
    post-multiplied by the inverse geometry2body pose (cpp:625-626)."""
    rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 12)
    poses = np.tile(np.eye(4, dtype=np.float64), (len(rows), 1, 1))
    # Columns are filled i-major: values [4*i + j] = pose(j, i).
    poses[:, :3, :4] = rows.reshape(-1, 4, 3).transpose(0, 2, 1)
    inv = np.linalg.inv(geometry2body_pose.astype(np.float64))
    return (poses @ inv).astype(np.float32)


class OPTEvaluator:
    """Evaluates the tracker on OPT run configurations (opt_evaluator.h:39+)."""

    def __init__(self, name: str, dataset_directory: str, external_directory: str,
                 body_names: list[str], body_orientations: list[str] | None = None,
                 motion_patterns: list[str] | None = None,
                 sequence_names: list[str] | None = None, device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.dataset_directory = str(dataset_directory)
        self.external_directory = str(external_directory)
        self.body_names = list(body_names)
        self.body_orientations = (list(body_orientations)
                                  if body_orientations is not None else None)
        self.motion_patterns = (list(motion_patterns)
                                if motion_patterns is not None else None)
        self.sequence_names = (list(sequence_names)
                               if sequence_names is not None else None)
        if self.sequence_names is None and self.body_orientations is None:
            self.body_orientations = BODY_ORIENTATIONS
            self.motion_patterns = MOTION_PATTERNS
        self.use_region_modality = True
        self.use_depth_modality = True
        self.intrinsics = OPT_INTRINSICS
        # Serve tracking through the fused cycle when the graph is
        # expressible (m3t_tpu_torch/fused_serve.py); the published OPT layout's
        # offset depth extrinsics fall back to the host path automatically.
        self.use_fused_pipeline = True
        self.tracker_setter = lambda t: None
        self.region_modality_setter = lambda m: None
        self.region_model_setter = lambda m: None
        self.depth_modality_setter = lambda m: None
        self.depth_model_setter = lambda m: None
        self.results: dict = {}

    def _run_configurations(self, body_name: str) -> list[dict]:
        if self.sequence_names is not None:
            return [{"sequence": s, "opt_layout": False}
                    for s in self.sequence_names]
        # Reference naming: "<body[:2]>_<pattern>_<orientation>"
        # (opt_evaluator.cpp:504-506).
        return [{"sequence": f"{body_name[:2]}_{pattern}_{orientation}",
                 "opt_layout": True}
                for orientation in self.body_orientations
                for pattern in self.motion_patterns]

    def _geometry2body_pose(self, body_name: str) -> np.ndarray:
        pose = np.eye(4, dtype=np.float32)
        if body_name in BODY2GEOMETRY2BODY_TRANSLATION:
            pose[:3, 3] = BODY2GEOMETRY2BODY_TRANSLATION[body_name]
        return pose

    def _make_body(self, body_name: str) -> Body:
        body = Body(
            body_name,
            geometry_path=os.path.join(self.dataset_directory, "Model3D", body_name,
                                       f"{body_name}.obj"),
            geometry_unit_in_meter=1.0, geometry_counterclockwise=True,
            geometry_enable_culling=True,
            geometry2body_pose=self._geometry2body_pose(body_name))
        if not body.SetUp():
            raise RuntimeError(f"Could not set up body {body_name}")
        return body

    def Evaluate(self) -> dict:  # noqa: N802
        all_results = {}
        for body_name in self.body_names:
            body = self._make_body(body_name)
            diameter = BODY2PRECOMPUTED_DIAMETER.get(
                body_name, body.maximum_body_diameter)
            vertices = metrics.reduce_vertices(body.triangle_vertices_f_body()
                                               .reshape(-1, 3))
            region_model = RegionModel(
                f"{body_name}_region_model", body,
                os.path.join(self.external_directory, f"{body_name}_region_model.npz"))
            self.region_model_setter(region_model)
            region_model.SetUp()
            depth_model = None
            if self.use_depth_modality:
                depth_model = DepthModel(
                    f"{body_name}_depth_model", body,
                    os.path.join(self.external_directory,
                                 f"{body_name}_depth_model.npz"))
                self.depth_model_setter(depth_model)
                depth_model.SetUp()

            for run in self._run_configurations(body_name):
                result = self._evaluate_sequence(
                    run, body, vertices, diameter, region_model, depth_model)
                all_results[(run["sequence"], body_name)] = result
                print(f"{run['sequence']} {body_name}: AUC = {result['auc']:.4f}")
        auc = float(np.mean([r["auc"] for r in all_results.values()])) \
            if all_results else 0.0
        times = {
            key: float(np.mean([r["execution_times"][key]
                                for r in all_results.values()]))
            for key in ("complete_cycle", "calculate_correspondences",
                        "calculate_gradient_and_hessian", "calculate_optimization",
                        "calculate_results")
        } if all_results else {}
        self.results = {"per_run": all_results, "auc": auc,
                        "execution_times": times}
        print(f"OPT average AUC: {auc:.4f}")
        return self.results

    def _evaluate_sequence(self, run, body, vertices, diameter,
                           region_model, depth_model) -> dict:
        sequence_name = run["sequence"]
        sequence_dir = os.path.join(self.dataset_directory, "3D", sequence_name)
        color_camera = LoaderColorCamera(
            "color_camera", load_directory=os.path.join(sequence_dir, "color"),
            intrinsics=self.intrinsics, load_index=1, n_leading_zeros=4)
        color_camera.SetUp()
        depth_camera = None
        if self.use_depth_modality:
            depth_camera = LoaderDepthCamera(
                "depth_camera", load_directory=os.path.join(sequence_dir, "depth"),
                intrinsics=self.intrinsics, depth_scale=0.001,
                load_index=1, n_leading_zeros=4)
            if run["opt_layout"]:
                # Depth camera sits at the depth2color extrinsics
                # (opt_evaluator.cpp:269-270; see DEPTH2COLOR_POSE note).
                depth_camera.set_camera2world_pose(DEPTH2COLOR_POSE)
            depth_camera.SetUp()

        if run["opt_layout"]:
            gt_poses = read_opt_gt_poses(
                os.path.join(self.dataset_directory, "3D", "poses",
                             f"{sequence_name}.txt"),
                body.geometry2body_pose)
        else:
            gt_poses = read_matrix_poses(
                os.path.join(sequence_dir, f"{body.name}.txt"))

        rg = RendererGeometry("rg", device=self.device)
        rg.AddBody(body)
        link = Link(f"{body.name}_link", body)
        if self.use_region_modality:
            modality = RegionModality(f"{body.name}_region_modality", body,
                                      color_camera, region_model, device=self.device)
            self.region_modality_setter(modality)
            link.AddModality(modality)
        if self.use_depth_modality and depth_camera is not None:
            modality = DepthModality(f"{body.name}_depth_modality", body,
                                     depth_camera, depth_model, device=self.device)
            self.depth_modality_setter(modality)
            link.AddModality(modality)
        optimizer = Optimizer(f"{body.name}_optimizer", link)
        detector = StaticDetector(f"{body.name}_detector", optimizer,
                                  link2world_pose=gt_poses[0])
        tracker = Tracker("tracker", synchronize_cameras=False,
                          use_fused_cycle=self.use_fused_pipeline)
        self.tracker_setter(tracker)
        tracker.AddOptimizer(optimizer)
        tracker.AddDetector(detector)
        if not tracker.SetUp():
            raise RuntimeError("tracker failed")

        curve = np.zeros(N_CURVE_VALUES)
        n_frames = 0
        phase_times = []
        tracker.names_detecting = set(tracker.names_all)
        tracker.names_starting = set(tracker.names_all)
        tracker._validate_names()
        tracker._assemble_internally_used_object_ptrs()
        for i in range(len(gt_poses) - 1):
            if not tracker.UpdateCameras(i):
                break
            tracker.CalculateConsistentPoses()
            tracker.ExecuteDetectingStep(i)
            tracker.ExecuteStartingStep(i)
            times = metrics.execute_tracking_step_maybe_fused(tracker, i)
            if times:
                phase_times.append(times)
            error = metrics.add_error(vertices, body.body2world_pose, gt_poses[i + 1])
            curve += metrics.opt_curve(error, diameter, N_CURVE_VALUES, THRESHOLD_MAX)
            n_frames += 1
        curve = curve / max(n_frames, 1)
        mean_times = {
            key: float(np.mean([t[key] for t in phase_times])) if phase_times else 0.0
            for key in ("complete_cycle", "calculate_correspondences",
                        "calculate_gradient_and_hessian", "calculate_optimization",
                        "calculate_results")
        }
        # Whether every step served through the fused cycle (its phases then come from
        # the cycle's stage marks).
        mean_times["fused"] = bool(phase_times) and all(t.get("fused", False)
                                                        for t in phase_times)
        return {
            "auc": float(np.mean(curve)),
            "curve": curve.tolist(),
            "execution_times": mean_times,
            "mean_cycle_time_s": mean_times["complete_cycle"],
            "n_frames": n_frames,
        }

    def SaveResults(self, path: str) -> None:  # noqa: N802
        """Result file with per-run curves + AUC (opt_evaluator.cpp SaveResults)."""
        import json

        serializable = {
            f"{seq}/{body}": r
            for (seq, body), r in self.results.get("per_run", {}).items()
        }
        serializable["auc"] = self.results.get("auc")
        serializable["execution_times"] = self.results.get("execution_times")
        with open(path, "w") as f:
            json.dump(serializable, f, indent=2)
