"""Evaluation metrics: RBOT success, ADD/ADD-S AUC, OPT curve AUC, Choi RMSE (a copy of
m3t_tpu/eval/metrics.py, which is numpy and scipy only; the step timers synchronise the
card).

Implements the reference's exact metric definitions:
  * RBOT: success iff err_t < 5 cm AND err_r < 5 deg (rbot_evaluator.h:39, cpp:416-432)
  * YCB-Video: ADD & ADD-S with 0-0.1 m threshold curve; per-frame AUC
    = 1 - min(err / 0.1, 1) (ycb_evaluator.cpp:CalculatePoseResults)
  * OPT: step curve over thresholds scaled by body diameter (opt_evaluator.cpp:462-484)
  * Choi: per-axis translation (mm) and XYZ-Euler rotation (deg) errors
    (choi_evaluator.cpp:461-475); RMSE over frames
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy.spatial import cKDTree


def translation_error(pose: np.ndarray, pose_gt: np.ndarray) -> float:
    return float(np.linalg.norm(pose[:3, 3] - pose_gt[:3, 3]))


def rotation_error(pose: np.ndarray, pose_gt: np.ndarray) -> float:
    trace = np.trace(pose[:3, :3].T @ pose_gt[:3, :3])
    return float(np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0)))


def tracking_success(pose: np.ndarray, pose_gt: np.ndarray,
                     translation_threshold: float = 0.05,
                     rotation_threshold: float = 5.0 * np.pi / 180.0) -> bool:
    """RBOT 5 cm / 5 deg criterion (rbot_evaluator.cpp:416-432)."""
    return (translation_error(pose, pose_gt) <= translation_threshold
            and rotation_error(pose, pose_gt) <= rotation_threshold)


def add_error(vertices: np.ndarray, pose: np.ndarray, pose_gt: np.ndarray) -> float:
    """Mean distance between model vertices under estimate vs ground truth."""
    delta = np.linalg.inv(pose.astype(np.float64)) @ pose_gt.astype(np.float64)
    v = np.asarray(vertices, np.float64)
    moved = v @ delta[:3, :3].T + delta[:3, 3]
    return float(np.mean(np.linalg.norm(v - moved, axis=1)))


def adds_error(vertices: np.ndarray, pose: np.ndarray, pose_gt: np.ndarray,
               kdtree: cKDTree | None = None) -> float:
    """Symmetric ADD: nearest-vertex distances (nanoflann equivalent: scipy cKDTree)."""
    delta = np.linalg.inv(pose.astype(np.float64)) @ pose_gt.astype(np.float64)
    v = np.asarray(vertices, np.float64)
    moved = v @ delta[:3, :3].T + delta[:3, 3]
    if kdtree is None:
        kdtree = cKDTree(v)
    dists, _ = kdtree.query(moved, k=1)
    return float(np.mean(dists))


def auc_from_error(error: float, threshold_max: float = 0.1) -> float:
    """Per-frame AUC contribution (ycb_evaluator.cpp: 1 - min(err/max, 1))."""
    return 1.0 - min(error / threshold_max, 1.0)


def error_curve(error: float, threshold_max: float = 0.1,
                n_curve_values: int = 100) -> np.ndarray:
    """Step curve: 1 for thresholds above the error (ycb_evaluator.cpp curve fill)."""
    thresholds = threshold_max / n_curve_values * (np.arange(n_curve_values) + 1)
    return (error < thresholds).astype(np.float32)


def opt_curve(error: float, diameter: float,
              n_curve_values: int = 100, threshold_max: float = 0.2) -> np.ndarray:
    """OPT success curve over diameter-normalized thresholds (opt_evaluator.cpp:479-483)."""
    thresholds = threshold_max / n_curve_values * (np.arange(n_curve_values) + 1)
    return (error < diameter * thresholds).astype(np.float32)


def choi_errors(pose: np.ndarray, pose_gt: np.ndarray) -> dict:
    """Per-axis translation (mm) + XYZ-Euler rotation (deg) errors
    (choi_evaluator.cpp:461-475)."""
    from scipy.spatial.transform import Rotation

    trans = (pose[:3, 3] - pose_gt[:3, 3]) * 1000.0
    eul = Rotation.from_matrix(pose[:3, :3]).as_euler("xyz")
    eul_gt = Rotation.from_matrix(pose_gt[:3, :3]).as_euler("xyz")
    rot = (eul - eul_gt) * 180.0 / np.pi
    return {
        "error_x": float(trans[0]), "error_y": float(trans[1]),
        "error_z": float(trans[2]),
        "error_alpha": float(rot[0]), "error_beta": float(rot[1]),
        "error_gamma": float(rot[2]),
    }


def rmse(values) -> float:
    values = np.asarray(values, np.float64)
    if len(values) == 0:
        return 0.0
    return float(np.sqrt(np.mean(values ** 2)))


def reduce_vertices(vertices: np.ndarray, max_vertices: int = 1000,
                    seed: int = 7) -> np.ndarray:
    """Random vertex subset for ADD computations (mirrors the evaluators' reduced
    vertice maps)."""
    vertices = np.asarray(vertices)
    if len(vertices) <= max_vertices:
        return vertices
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(vertices), size=max_vertices, replace=False)
    return vertices[idx]


def _tracker_devices(tracker) -> list:
    """The CUDA devices that the tracker's modalities hold their tensors on."""
    devices = {getattr(m, "device", None) for m in tracker.modality_ptrs}
    return [d for d in devices if isinstance(d, torch.device) and d.type == "cuda"]


def _clock(devices) -> float:
    """time.perf_counter() once every kernel queued on ``devices`` has finished, so that
    a phase's device time is charged to that phase and not to the next."""
    for device in devices:
        torch.cuda.synchronize(device)
    return time.perf_counter()


def execute_measured_tracking_step(tracker, iteration: int) -> dict:
    """Run one tracking step phase-by-phase with timers.

    The analogue of the reference evaluators' ExecuteMeasuredTrackingCycle
    (ycb_evaluator.cpp:591-680, opt_evaluator.cpp): per-phase wall times in
    seconds with the reference's ExecutionTimes field names.  On the card each timer
    stops after the tracker's devices have finished their queued kernels.
    """
    devices = _tracker_devices(tracker)
    times = {"calculate_correspondences": 0.0,
             "calculate_gradient_and_hessian": 0.0,
             "calculate_optimization": 0.0,
             "calculate_results": 0.0}
    begin_cycle = _clock(devices)
    for corr_iteration in range(tracker.n_corr_iterations):
        begin = _clock(devices)
        if not tracker.CalculateCorrespondences(iteration, corr_iteration):
            return {}
        times["calculate_correspondences"] += _clock(devices) - begin
        for update_iteration in range(tracker.n_update_iterations):
            begin = _clock(devices)
            if not tracker.CalculateGradientAndHessian(
                    iteration, corr_iteration, update_iteration):
                return {}
            times["calculate_gradient_and_hessian"] += _clock(devices) - begin
            begin = _clock(devices)
            if not tracker.CalculateOptimization(
                    iteration, corr_iteration, update_iteration):
                return {}
            times["calculate_optimization"] += _clock(devices) - begin
    begin = _clock(devices)
    if not tracker.CalculateResults(iteration):
        return {}
    times["calculate_results"] += _clock(devices) - begin
    times["complete_cycle"] = _clock(devices) - begin_cycle
    return times


def execute_tracking_step_maybe_fused(tracker, iteration: int) -> dict:
    """execute_measured_tracking_step, or, when the tracker serves through the fused
    cycle (m3t_tpu_torch/fused_serve.py), one whole-step timing that ends at a host read
    of the poses, with the phases read off the cycle's stage marks: the tracer is on for
    the step, and each phase is the device seconds of its stages
    (``pipeline.STAGE_PHASES``; utils/timing.py).  The copies into the graph's buffers
    and the outputs' clones belong to no phase."""
    if getattr(tracker, "use_fused_cycle", False) \
            and tracker._fused_serve_backend() is not None:
        from m3t_tpu_torch.pipeline import STAGE_PHASES
        from m3t_tpu_torch.utils import timing

        times = dict.fromkeys(("calculate_correspondences",
                               "calculate_gradient_and_hessian", "calculate_optimization",
                               "calculate_results"), 0.0)
        with timing.tracing():
            before = timing.stage_seconds()
            begin = time.perf_counter()
            if not tracker.ExecuteTrackingStep(iteration):
                return {}
            complete = time.perf_counter() - begin
            after = timing.stage_seconds()
        for graph, stages in after.items():
            for stage, (seconds, _) in stages.items():
                if stage in STAGE_PHASES:
                    earlier = before.get(graph, {}).get(stage, (0.0, 0))[0]
                    times[STAGE_PHASES[stage]] += seconds - earlier
        return dict(complete_cycle=complete, **times, fused=True)
    return execute_measured_tracking_step(tracker, iteration)
