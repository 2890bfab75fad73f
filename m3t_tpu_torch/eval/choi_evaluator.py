"""Choi RGB-D dataset evaluator (port of m3t_tpu/eval/choi_evaluator.py; reference
M3T/examples/choi_evaluator.{h,cpp}).

Synthetic kitchen sequences per body ("seq_synth_<body>_kitchen"); metric = per-axis
RMSE of translation (mm) and XYZ-Euler rotation (deg) errors (choi_evaluator.cpp:461-475).
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

CHOI_INTRINSICS = Intrinsics(525.0, 525.0, 319.0, 239.0, 640, 480)  # choi_evaluator.h:41-42


class ChoiEvaluator:
    def __init__(self, name: str, dataset_directory: str, external_directory: str,
                 body_names: list[str], device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.dataset_directory = str(dataset_directory)
        self.external_directory = str(external_directory)
        self.body_names = list(body_names)
        self.use_region_modality = True
        self.use_depth_modality = True
        self.intrinsics = CHOI_INTRINSICS
        # Serve tracking through the fused cycle when the graph is
        # expressible (m3t_tpu_torch/fused_serve.py), host path otherwise.
        self.use_fused_pipeline = True
        self.tracker_setter = lambda t: None
        self.region_modality_setter = lambda m: None
        self.region_model_setter = lambda m: None
        self.depth_modality_setter = lambda m: None
        self.depth_model_setter = lambda m: None
        self.results: dict = {}

    def Evaluate(self) -> dict:  # noqa: N802
        all_results = {}
        for body_name in self.body_names:
            result = self._evaluate_body(body_name)
            all_results[body_name] = result
            print(f"{body_name}: rmse_trans = "
                  f"({result['rmse_x']:.2f}, {result['rmse_y']:.2f}, "
                  f"{result['rmse_z']:.2f}) mm")
        self.results = {"per_body": all_results}
        return self.results

    def _evaluate_body(self, body_name: str) -> dict:
        # Meshes live in the EXTERNAL directory (converted by the dataset
        # converter, choi_evaluator.cpp:513-516); fall back to the dataset dir.
        geometry_path = os.path.join(self.external_directory, "models",
                                     f"{body_name}.obj")
        if not os.path.exists(geometry_path):
            geometry_path = os.path.join(self.dataset_directory, "models",
                                         f"{body_name}.obj")
        body = Body(
            body_name, geometry_path=geometry_path,
            geometry_unit_in_meter=1.0, geometry_counterclockwise=True,
            geometry_enable_culling=True)
        if not body.SetUp():
            raise RuntimeError(f"Could not set up body {body_name}")

        camera_dir = os.path.join(self.external_directory,
                                  f"seq_synth_{body_name}_kitchen")
        color_camera = LoaderColorCamera(
            "color_camera", load_directory=camera_dir, intrinsics=self.intrinsics,
            image_name_pre="color", load_index=0, n_leading_zeros=4)
        color_camera.SetUp()
        depth_camera = LoaderDepthCamera(
            "depth_camera", load_directory=camera_dir, intrinsics=self.intrinsics,
            depth_scale=0.0001, image_name_pre="depth", load_index=0,
            n_leading_zeros=4)
        depth_camera.SetUp()

        # GT poses: "<dataset>/ground_truth/<body>_kitchen.motion", 12 row-major
        # [R | t] values per line (choi_evaluator.cpp:549-575); synthetic mini
        # datasets may instead place poses_gt.{npy,txt} next to the images.
        motion_path = os.path.join(self.dataset_directory, "ground_truth",
                                   f"{body_name}_kitchen.motion")
        if os.path.exists(motion_path):
            gt_poses = self._read_motion_file(motion_path)
        elif os.path.exists(os.path.join(camera_dir, "poses_gt.npy")):
            gt_poses = np.load(os.path.join(camera_dir, "poses_gt.npy"))
        else:
            gt_poses = self._read_gt_poses(camera_dir)

        region_model = RegionModel(
            f"{body_name}_region_model", body,
            os.path.join(self.external_directory, f"{body_name}_region_model.npz"))
        self.region_model_setter(region_model)
        region_model.SetUp()
        depth_model = DepthModel(
            f"{body_name}_depth_model", body,
            os.path.join(self.external_directory, f"{body_name}_depth_model.npz"))
        self.depth_model_setter(depth_model)
        depth_model.SetUp()

        rg = RendererGeometry("rg", device=self.device)
        rg.AddBody(body)
        link = Link(f"{body_name}_link", body)
        if self.use_region_modality:
            modality = RegionModality(f"{body_name}_region_modality", body,
                                      color_camera, region_model, device=self.device)
            self.region_modality_setter(modality)
            modality.MeasureOcclusions(depth_camera)
            link.AddModality(modality)
        if self.use_depth_modality:
            modality = DepthModality(f"{body_name}_depth_modality", body,
                                     depth_camera, depth_model, device=self.device)
            self.depth_modality_setter(modality)
            modality.MeasureOcclusions()
            link.AddModality(modality)
        optimizer = Optimizer(f"{body_name}_optimizer", link)
        detector = StaticDetector(f"{body_name}_detector", optimizer,
                                  link2world_pose=gt_poses[0])
        tracker = Tracker("tracker", synchronize_cameras=False,
                          use_fused_cycle=self.use_fused_pipeline)
        self.tracker_setter(tracker)
        tracker.AddOptimizer(optimizer)
        tracker.AddDetector(detector)
        if not tracker.SetUp():
            raise RuntimeError("tracker failed")

        errors = []
        phase_times = []
        t_errors, r_errors = [], []
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
            errors.append(metrics.choi_errors(body.body2world_pose, gt_poses[i + 1]))
            t_errors.append(metrics.translation_error(body.body2world_pose,
                                                      gt_poses[i + 1]))
            r_errors.append(metrics.rotation_error(body.body2world_pose,
                                                   gt_poses[i + 1]))

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
            "rmse_x": metrics.rmse([e["error_x"] for e in errors]),
            "rmse_y": metrics.rmse([e["error_y"] for e in errors]),
            "rmse_z": metrics.rmse([e["error_z"] for e in errors]),
            "rmse_alpha": metrics.rmse([e["error_alpha"] for e in errors]),
            "rmse_beta": metrics.rmse([e["error_beta"] for e in errors]),
            "rmse_gamma": metrics.rmse([e["error_gamma"] for e in errors]),
            "mean_translation_error": float(np.mean(t_errors)) if t_errors else 0.0,
            "mean_rotation_error": float(np.mean(r_errors)) if r_errors else 0.0,
            "execution_times": mean_times,
            "mean_cycle_time_s": mean_times["complete_cycle"],
            "n_frames": len(errors),
        }

    @staticmethod
    def _read_motion_file(path: str) -> np.ndarray:
        """Choi .motion file: 12 row-major [R | t] values per line
        (choi_evaluator.cpp:560-571)."""
        rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 12)
        poses = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
        poses[:, :3, :4] = rows.reshape(-1, 3, 4).astype(np.float32)
        return poses

    @staticmethod
    def _read_gt_poses(camera_dir: str) -> np.ndarray:
        path = os.path.join(camera_dir, "poses_gt.txt")
        rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 12)
        poses = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
        poses[:, :3, :3] = rows[:, :9].reshape(-1, 3, 3).astype(np.float32)
        poses[:, :3, 3] = rows[:, 9:12].astype(np.float32)
        return poses
