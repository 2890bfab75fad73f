"""RTB dataset evaluator (port of m3t_tpu/eval/rtb_evaluator.py; reference
M3T/examples/rtb_evaluator.{h,cpp}).

Multi-body kinematic structures (6 robots x 3 difficulty levels x 4 depth qualities x
10 sequences x 150 frames, Mb-ICG/readme.md:60-66) tracked with region+depth modalities;
metric = per-body ADD / ADD-S AUC like YCB (rtb_evaluator.h:67-75).  Kinematic structures
come from generator YAML configs in the dataset; the four evaluation modes mirror the
reference (independent bodies / projected kinematics / constrained / combined).

Expected layout (rtb_evaluator.cpp:713-736):
  <dataset>/<object>/model/tracker_config/<mode>.yaml   generator config
  <dataset>/<object>/<difficulty>/<seq:03d>/rgb/        color frames
  <dataset>/<object>/<difficulty>/<seq:03d>/<depth>/    depth frames
  <dataset>/<object>/<difficulty>/<seq:03d>/poses_gt/<body>.txt  rows 9 rot + 3 trans

Every tensor lives on ``device`` (the card unless the caller asks for the CPU): the
generated trackers' objects, and the kinematic model, model arrays, frames and state of
the fused path.
"""

from __future__ import annotations

import enum
import os
import time

import numpy as np
import torch
from scipy.spatial import cKDTree

from m3t_tpu_torch import pipeline
from m3t_tpu_torch.camera import LoaderColorCamera, LoaderDepthCamera
from m3t_tpu_torch.common import resolve_device, to_numpy
from m3t_tpu_torch.depth_modality import DepthModality
from m3t_tpu_torch.eval import metrics
from m3t_tpu_torch.generator import GenerateConfiguredTracker
from m3t_tpu_torch.ops import kinematics as kin_ops
from m3t_tpu_torch.region_modality import RegionModality

RTB_INTRINSICS = dict(fu=1000.0, fv=1000.0, ppu=640.0, ppv=480.0,
                      width=1280, height=960)
N_CURVE_VALUES = 100
THRESHOLD_MAX = 0.1
OBJECT2SIZE_MULTIPLIER = {
    "gripper": 1.0, "medical_pliers": 1.0, "medical_robot": 3.0,
    "picker_robot": 1.0, "robot_fingers": 1.0, "robot_wrist": 1.0,
}


class EvaluationMode(enum.Enum):
    INDEPENDENT = 0
    PROJECTED = 1
    CONSTRAINED = 2
    COMBINED = 3


class _NotExpressible(RuntimeError):
    """Raised when a configured object graph cannot run on the fused path."""


def _tile(batch, r: int):
    """Every tensor of a batch of S structures (or bodies) repeated r times along the
    batch: the (R * S, ...) batch of R runs of the same structures."""
    return type(batch)(*(a.repeat((r,) + (1,) * (a.ndim - 1)) for a in batch))


class RTBEvaluator:
    def __init__(self, name: str, dataset_directory: str, external_directory: str,
                 object_names: list[str], difficulty_levels: list[str],
                 depth_names: list[str], sequence_numbers: list[int],
                 device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.dataset_directory = str(dataset_directory)
        self.external_directory = str(external_directory)
        self.object_names = list(object_names)
        self.difficulty_levels = list(difficulty_levels)
        self.depth_names = list(depth_names)
        self.sequence_numbers = list(sequence_numbers)
        self.evaluation_mode = EvaluationMode.COMBINED
        self.use_region_modality = True
        self.use_depth_modality = True
        self.tracker_setter = lambda t: None
        # Throughput path (DEFAULT): all (difficulty, depth, sequence) runs
        # of one object track as ONE batch of kinematic structures through
        # pipeline.tracking_cycle_kinematic (per-link region+depth terms into
        # the batched adjoint-chain KKT solve — the Mb-ICG/RTB configuration,
        # rtb_evaluator.cpp run loop + link.cpp:184-193).  Object graphs the
        # fused path cannot express fall back to the host path with a notice.
        self.use_fused_pipeline = True
        self.pipeline_config = None  # Optional m3t_tpu_torch.pipeline.PipelineConfig
        # External-pose comparison flow (rtb_evaluator.cpp:452-462,481-483):
        # with evaluate_external, per-frame poses produced by an external method
        # (e.g. the reference's MATLAB pipeline) are loaded from
        # <external>/poses/<external_results_folder>/... and scored with the
        # same ADD/ADD-S AUC metric instead of tracking.  save_poses_folder
        # writes this evaluator's own tracked poses in the same layout so they
        # can feed that comparison.
        self.evaluate_external = False
        self.external_results_folder = ""
        self.save_poses_folder = None
        self.results: dict = {}

    def _config_path(self, object_name: str) -> str:
        """Mode-specific generator config (rtb_evaluator.cpp:512-528: config.yaml
        for COMBINED, config_<mode>.yaml otherwise; the repo's <mode>.yaml naming
        is accepted as a fallback)."""
        base = os.path.join(self.dataset_directory, object_name, "model",
                            "tracker_config")
        mode = self.evaluation_mode
        names = (["config.yaml"] if mode == EvaluationMode.COMBINED
                 else [f"config_{mode.name.lower()}.yaml"])
        names.append(f"{mode.name.lower()}.yaml")
        for name in names:
            path = os.path.join(base, name)
            if os.path.exists(path):
                return path
        return os.path.join(base, names[0])

    def _pose_dir(self, folder, object_name, difficulty, depth_name, seq):
        return os.path.join(self.external_directory, "poses", folder,
                            object_name, difficulty, depth_name, f"{seq:03d}")

    def _save_run_poses(self, object_name, run, poses_per_body) -> None:
        """Write tracked per-frame body2world poses (12 row-major values per
        line, the dataset's poses_gt format) for the external comparison flow."""
        if not self.save_poses_folder:
            return
        directory = self._pose_dir(self.save_poses_folder, object_name, *run)
        os.makedirs(directory, exist_ok=True)
        for body_name, poses in poses_per_body.items():
            with open(os.path.join(directory, f"{body_name}.txt"), "w") as f:
                for pose in poses:
                    row = list(np.asarray(pose)[:3, :3].reshape(-1)) + list(
                        np.asarray(pose)[:3, 3])
                    f.write(" ".join(f"{v:.9f}" for v in row) + "\n")

    def _evaluate_external_run(self, object_name, run, body_names,
                               vertices, kdtrees, gt, threshold) -> dict:
        """Score externally produced poses with the tracker's own metric
        (rtb_evaluator.cpp:481-483: frame i's external pose vs GT row i+1)."""
        directory = self._pose_dir(self.external_results_folder, object_name,
                                   *run)
        external = self._load_gt_poses(directory, body_names)
        if not external:
            raise RuntimeError(f"no external poses under {directory}")
        # External pose i is scored against GT row i + 1 (the tracked pose for
        # frame i, like the tracking loop).
        n_frames = min(min((len(p) for p in external.values()), default=0),
                       min((len(p) for p in gt.values()), default=0) - 1)
        add_aucs, adds_aucs = [], []
        for i in range(max(n_frames, 0)):
            frame_add, frame_adds = [], []
            for body_name, poses in external.items():
                if body_name not in gt:
                    continue
                add = metrics.add_error(vertices[body_name], poses[i],
                                        gt[body_name][i + 1])
                adds = metrics.adds_error(vertices[body_name], poses[i],
                                          gt[body_name][i + 1],
                                          kdtrees[body_name])
                frame_add.append(metrics.auc_from_error(add, threshold))
                frame_adds.append(metrics.auc_from_error(adds, threshold))
            if frame_add:
                add_aucs.append(float(np.mean(frame_add)))
                adds_aucs.append(float(np.mean(frame_adds)))
        return {
            "add_auc": float(np.mean(add_aucs)) if add_aucs else 0.0,
            "adds_auc": float(np.mean(adds_aucs)) if adds_aucs else 0.0,
            "mean_cycle_time_s": 0.0,
            "n_frames": len(add_aucs),
        }

    def _evaluate_object_external(self, config_path, object_name, runs) -> dict:
        tracker = GenerateConfiguredTracker(config_path, device=self.device)
        tracker._assemble_derived_object_ptrs()
        body_names = [b.name for b in tracker.body_ptrs]
        for body in tracker.body_ptrs:
            if not body.set_up:
                body.SetUp()
        multiplier = OBJECT2SIZE_MULTIPLIER.get(object_name, 1.0)
        vertices, kdtrees = {}, {}
        for body in tracker.body_ptrs:
            v = metrics.reduce_vertices(
                body.triangle_vertices_f_body().reshape(-1, 3))
            vertices[body.name] = v
            kdtrees[body.name] = cKDTree(v)
        out = {}
        for run in runs:
            _, _, gt_dir = self._sequence_dirs(object_name, *run)
            gt = self._load_gt_poses(gt_dir, body_names)
            out[run] = self._evaluate_external_run(
                object_name, run, body_names, vertices, kdtrees, gt,
                THRESHOLD_MAX * multiplier)
        return out

    def Evaluate(self) -> dict:  # noqa: N802
        all_results = {}
        for object_name in self.object_names:
            config_path = self._config_path(object_name)
            runs = [(difficulty, depth_name, seq)
                    for difficulty in self.difficulty_levels
                    for depth_name in self.depth_names
                    for seq in self.sequence_numbers]
            if self.evaluate_external:
                for run, result in self._evaluate_object_external(
                        config_path, object_name, runs).items():
                    key = (object_name,) + run
                    all_results[key] = result
                    print(f"{object_name}/{run[0]}/{run[1]}/{run[2]:03d} "
                          f"(external {self.external_results_folder}): "
                          f"ADD AUC = {result['add_auc']:.4f}")
                continue
            fused_results = None
            if self.use_fused_pipeline:
                try:
                    fused_results = self._evaluate_object_fused(
                        config_path, object_name, runs)
                except _NotExpressible as e:
                    print(f"RTBEvaluator: fused path unavailable for "
                          f"{object_name} ({e}); using the object-graph path")
            if fused_results is not None:
                for run, result in fused_results.items():
                    key = (object_name,) + run
                    all_results[key] = result
                    print(f"{object_name}/{run[0]}/{run[1]}/{run[2]:03d} "
                          f"(fused): ADD AUC = {result['add_auc']:.4f}")
            else:
                for difficulty, depth_name, seq in runs:
                    key = (object_name, difficulty, depth_name, seq)
                    result = self._evaluate_sequence(
                        GenerateConfiguredTracker(config_path, device=self.device),
                        object_name, difficulty, depth_name, seq)
                    all_results[key] = result
                    print(f"{object_name}/{difficulty}/{depth_name}/{seq:03d}: "
                          f"ADD AUC = {result['add_auc']:.4f}")
        flat = list(all_results.values())
        self.results = {
            "per_run": all_results,
            "add_auc": float(np.mean([r["add_auc"] for r in flat])) if flat else 0.0,
            "adds_auc": float(np.mean([r["adds_auc"] for r in flat])) if flat else 0.0,
        }
        return self.results

    def _sequence_dirs(self, object_name, difficulty, depth_name, seq):
        sequence_base = os.path.join(self.dataset_directory, object_name,
                                     difficulty, f"{seq:03d}")
        return (os.path.join(sequence_base, "rgb"),
                os.path.join(sequence_base, depth_name),
                os.path.join(sequence_base, "poses_gt"))

    @staticmethod
    def _load_gt_poses(gt_dir, body_names):
        gt = {}
        for body_name in body_names:
            path = os.path.join(gt_dir, f"{body_name}.txt")
            if not os.path.exists(path):
                continue
            rows = np.loadtxt(path, dtype=np.float64).reshape(-1, 12)
            poses = np.tile(np.eye(4, dtype=np.float32), (len(rows), 1, 1))
            poses[:, :3, :3] = rows[:, :9].reshape(-1, 3, 3)
            poses[:, :3, 3] = rows[:, 9:12]
            gt[body_name] = poses
        return gt

    def _evaluate_object_fused(self, config_path, object_name, runs) -> dict:
        """All runs of one object as a batch of structures through
        tracking_cycle_kinematic (+ depth fusion when configured)."""
        dev = self.device
        tracker = GenerateConfiguredTracker(config_path, device=dev)
        tracker._assemble_derived_object_ptrs()
        self.tracker_setter(tracker)
        color_tmpl = next((c for c in tracker.camera_ptrs
                           if isinstance(c, LoaderColorCamera)), None)
        depth_tmpl = next((c for c in tracker.camera_ptrs
                           if isinstance(c, LoaderDepthCamera)), None)
        if color_tmpl is None:
            raise _NotExpressible("no loader color camera in config")
        # Point the template cameras at the first run so Tracker.SetUp (models,
        # modalities, optimizers) can complete; per-run cameras stream below.
        color0, depth0, _ = self._sequence_dirs(object_name, *runs[0])
        for camera in (color_tmpl, depth_tmpl):
            if camera is None:
                continue
            if camera.metafile_path:
                camera._load_loader_metadata(
                    require_depth_scale=isinstance(camera, LoaderDepthCamera))
                camera.metafile_path = None
            camera.load_directory = (depth0 if isinstance(camera,
                                                          LoaderDepthCamera)
                                     else color0)
            camera.load_index = 0
        if not tracker.SetUp():
            raise RuntimeError("tracker failed to set up")

        optimizers = tracker.optimizer_ptrs
        links = []
        region_modalities = []
        depth_modalities = []
        for opt in optimizers:
            for link in opt.ReferencedLinks():
                if not link.fixed_body2joint_pose:
                    raise _NotExpressible(
                        f"link {link.name} has fixed_body2joint_pose=False")
                rms = [m for m in link.modality_ptrs
                       if isinstance(m, RegionModality)]
                if len(rms) != 1:
                    raise _NotExpressible(
                        f"link {link.name} needs exactly one region modality")
                dms = [m for m in link.modality_ptrs
                       if isinstance(m, DepthModality)]
                links.append(link)
                region_modalities.append(rms[0])
                depth_modalities.append(dms[0] if dms else None)
        s0 = len(optimizers)
        nl = max(len(opt.ReferencedLinks()) for opt in optimizers)
        if any(len(opt.ReferencedLinks()) != nl for opt in optimizers):
            raise _NotExpressible("optimizers with unequal link counts")
        has_depth = [m is not None for m in depth_modalities]
        if any(has_depth) and not all(has_depth):
            # The host path would sum depth terms on the links that have them;
            # the fused cycle cannot express a per-link depth subset.
            raise _NotExpressible("depth modality on some links only")
        use_depth = all(has_depth) and bool(has_depth) and depth_tmpl is not None
        if use_depth and not self.use_depth_modality:
            raise _NotExpressible(
                "use_depth_modality=False but the config has depth modalities")

        # Configured-parameter fidelity (the fused cycle applies ONE parameter
        # set to every link; the host path is the fallback for anything else).
        rm0 = region_modalities[0]
        for rm in region_modalities:
            if (rm._cfg != rm0._cfg or list(rm.scales) != list(rm0.scales)
                    or list(rm.standard_deviations)
                    != list(rm0.standard_deviations)
                    or rm.use_adaptive_coverage != rm0.use_adaptive_coverage
                    or rm.reference_contour_length
                    != rm0.reference_contour_length
                    or rm.learning_rate_f != rm0.learning_rate_f
                    or rm.learning_rate_b != rm0.learning_rate_b
                    or rm.n_unoccluded_iterations
                    != rm0.n_unoccluded_iterations):
                raise _NotExpressible(
                    "region modality parameters differ across links")
            if rm.measure_occlusions:
                raise _NotExpressible(
                    f"modality {rm.name} measures occlusions (not supported "
                    "by the fused kinematic cycle)")
            if rm.model_occlusions or rm.use_region_checking:
                raise _NotExpressible(
                    f"modality {rm.name} uses renderers (no scene geometry "
                    "on the fused RTB path)")
            if rm.use_shared_color_histograms:
                raise _NotExpressible(f"modality {rm.name} shares histograms")
        dm0 = depth_modalities[0] if use_depth else None
        if use_depth:
            for dm in depth_modalities:
                if (dm._cfg != dm0._cfg
                        or list(dm.considered_distances)
                        != list(dm0.considered_distances)
                        or list(dm.standard_deviations)
                        != list(dm0.standard_deviations)
                        or dm.measure_occlusions != dm0.measure_occlusions
                        or dm.n_unoccluded_iterations
                        != dm0.n_unoccluded_iterations):
                    raise _NotExpressible(
                        "depth modality parameters differ across links")
                if dm.model_occlusions or dm.use_silhouette_checking:
                    raise _NotExpressible(
                        f"modality {dm.name} uses renderers (no scene "
                        "geometry on the fused RTB path)")
            # tracking_cycle_kinematic evaluates depth in the color camera's
            # frame with the color intrinsics.
            di, ci = depth_tmpl.intrinsics, color_tmpl.intrinsics
            if (di.fu, di.fv, di.ppu, di.ppv, di.width, di.height) != \
                    (ci.fu, ci.fv, ci.ppu, ci.ppv, ci.width, ci.height):
                raise _NotExpressible(
                    "depth camera intrinsics differ from color camera")
            if not np.allclose(np.asarray(depth_tmpl.world2camera_pose),
                               np.asarray(color_tmpl.world2camera_pose),
                               atol=1e-7):
                raise _NotExpressible(
                    "depth camera extrinsics differ from color camera")
        opt0 = optimizers[0]
        for opt in optimizers:
            if (opt.tikhonov_parameter_rotation
                    != opt0.tikhonov_parameter_rotation
                    or opt.tikhonov_parameter_translation
                    != opt0.tikhonov_parameter_translation):
                raise _NotExpressible(
                    "tikhonov parameters differ across optimizers")

        pcfg = self.pipeline_config
        if pcfg is None:
            pcfg = pipeline.PipelineConfig(
                cfg=rm0._cfg,
                scales=tuple(rm0.scales),
                standard_deviations=tuple(rm0.standard_deviations),
                n_corr_iterations=tracker.n_corr_iterations,
                n_update_iterations=tracker.n_update_iterations,
                tikhonov_rotation=float(opt0.tikhonov_parameter_rotation),
                tikhonov_translation=float(opt0.tikhonov_parameter_translation),
                learning_rate_f=float(rm0.learning_rate_f),
                learning_rate_b=float(rm0.learning_rate_b),
                use_adaptive_coverage=bool(rm0.use_adaptive_coverage),
                reference_contour_length=float(rm0.reference_contour_length),
                use_depth=use_depth)
            if use_depth:
                pcfg = pcfg._replace(
                    depth_cfg=dm0._cfg,
                    considered_distances=tuple(dm0.considered_distances),
                    depth_standard_deviations=tuple(dm0.standard_deviations),
                    depth_measure_occlusions=bool(dm0.measure_occlusions))
        pcfg = pcfg._replace(use_depth=use_depth)
        n_lines = pcfg.cfg.n_lines_max
        n_unoccluded = dm0.n_unoccluded_iterations if use_depth else 0

        kin_1 = kin_ops.build_kinematic_model(optimizers, n_links=nl, device=dev)
        arrays_1 = pipeline.RegionModelArrays.from_models(
            [m.region_model_ptr for m in region_modalities], n_lines, device=dev)
        darrays_1 = None
        if use_depth:
            darrays_1 = pipeline.DepthModelArrays.from_models(
                [m.depth_model_ptr for m in depth_modalities],
                pcfg.depth_cfg.n_points_max, device=dev)

        r = len(runs)
        kin = _tile(kin_1, r)
        arrays = _tile(arrays_1, r)
        darrays = _tile(darrays_1, r) if darrays_1 is not None else None

        w2c = np.asarray(color_tmpl.world2camera_pose, np.float32)
        c2w = np.linalg.inv(w2c.astype(np.float64)).astype(np.float32)
        intr_o = color_tmpl.intrinsics
        intr = (np.float32(intr_o.fu), np.float32(intr_o.fv),
                np.float32(intr_o.ppu), np.float32(intr_o.ppv))
        multiplier = OBJECT2SIZE_MULTIPLIER.get(object_name, 1.0)
        threshold = THRESHOLD_MAX * multiplier

        link_body_names = [l.body_ptr.name for l in links]
        vertices = {}
        kdtrees = {}
        for link in links:
            body = link.body_ptr
            if body.name in vertices:
                continue
            v = metrics.reduce_vertices(
                body.triangle_vertices_f_body().reshape(-1, 3))
            vertices[body.name] = v
            kdtrees[body.name] = cKDTree(v)

        # Per-run cameras + GT + initial DOF state.
        color_cams, depth_cams, gt_list, jp0_list = [], [], [], []
        for run in runs:
            color_dir, depth_dir, gt_dir = self._sequence_dirs(object_name,
                                                               *run)
            cam = LoaderColorCamera(
                f"rtb_color_{run}", load_directory=color_dir,
                intrinsics=intr_o, image_name_pre=color_tmpl.image_name_pre,
                load_index=0, n_leading_zeros=color_tmpl.n_leading_zeros,
                image_name_post=color_tmpl.image_name_post,
                load_image_type=color_tmpl.load_image_type)
            cam.set_world2camera_pose(w2c)
            if not cam.SetUp():
                raise RuntimeError(f"color camera for run {run} failed")
            color_cams.append(cam)
            if use_depth:
                dcam = LoaderDepthCamera(
                    f"rtb_depth_{run}", load_directory=depth_dir,
                    intrinsics=depth_tmpl.intrinsics,
                    depth_scale=depth_tmpl.depth_scale,
                    image_name_pre=depth_tmpl.image_name_pre, load_index=0,
                    n_leading_zeros=depth_tmpl.n_leading_zeros,
                    image_name_post=depth_tmpl.image_name_post,
                    load_image_type=depth_tmpl.load_image_type)
                dcam.set_world2camera_pose(
                    np.asarray(depth_tmpl.world2camera_pose, np.float32))
                if not dcam.SetUp():
                    raise RuntimeError(f"depth camera for run {run} failed")
                depth_cams.append(dcam)
            gt = self._load_gt_poses(gt_dir, set(link_body_names))
            gt_list.append(gt)
            # Detector initialization: root link at GT frame 0, joints at their
            # configured defaults (StaticDetector reset semantics).
            for opt in optimizers:
                root = opt.root_link_ptr
                root_body = root.body_ptr
                if root_body is not None and root_body.name in gt:
                    root.set_link2world_pose(gt[root_body.name][0])
                for link in opt.ReferencedLinks():
                    link.joint2parent_pose = link.default_joint2parent_pose.copy()
            jp0_list.append(kin_ops.initial_joint2parent(
                optimizers, world2camera=w2c, n_links=nl, device=dev))
        jp0 = torch.cat(jp0_list)  # (R*S0, NL, 4, 4)

        def batch_images():
            color = np.stack([np.asarray(c.image) for c in color_cams])
            color = np.repeat(color, s0, axis=0)
            depth = None
            if use_depth:
                depth = np.stack([np.asarray(c.image) for c in depth_cams])
                depth = np.repeat(depth, s0, axis=0)
            return (torch.as_tensor(color, device=dev),
                    torch.as_tensor(depth, device=dev) if depth is not None else None)

        results = {run: {"add_aucs": [], "adds_aucs": [], "cycle_times": []}
                   for run in runs}
        saved = {run: {name: [] for name in link_body_names} for run in runs}
        active = [True] * r
        n_frames = [min((len(p) for p in gt.values()), default=0)
                    for gt in gt_list]

        for c in color_cams:
            if not c.UpdateImage():
                raise RuntimeError("first frame failed to load")
        for c in depth_cams:
            if not c.UpdateImage():
                raise RuntimeError("first depth frame failed to load")
        images, depth_images = batch_images()
        state = pipeline.initialize_kinematic_histograms(
            pcfg, intr, images, arrays, kin, jp0.reshape(r * s0, nl, 4, 4))

        # Frame loop mirroring _evaluate_sequence: the cycle runs on frame i
        # (frame 0 included — StartModalities and the first tracking step share
        # the first image, like the host path) and is scored against GT row
        # i + 1.
        frame = 0
        while any(active):
            images, depth_images = batch_images()
            begin = time.perf_counter()
            # Starting protocol: occlusion handling off for the first
            # n_unoccluded_iterations after StartModalities (depth_modality
            # warm-up, region_modality.h:442-equivalent).
            handle_occ = torch.as_tensor(frame >= n_unoccluded, device=dev)
            if use_depth:
                state = pipeline.tracking_cycle_kinematic(
                    pcfg, intr, images, arrays, kin, state,
                    handle_occlusions=handle_occ, depth_intr=intr,
                    depth_scale=np.float32(depth_tmpl.depth_scale),
                    depth_images=depth_images, depth_model=darrays)
            else:
                state = pipeline.tracking_cycle_kinematic(
                    pcfg, intr, images, arrays, kin, state,
                    handle_occlusions=handle_occ)
            b2c = to_numpy(pipeline.kinematic_body_poses(kin, state))
            elapsed = time.perf_counter() - begin

            for i_run, run in enumerate(runs):
                if not active[i_run] or frame + 1 >= n_frames[i_run]:
                    continue
                if self.save_poses_folder:
                    for s_idx in range(s0):
                        for l_idx, link in enumerate(
                                optimizers[s_idx].ReferencedLinks()):
                            saved[run][link.body_ptr.name].append(
                                c2w @ b2c[i_run * s0 + s_idx, l_idx])
                gt = gt_list[i_run]
                frame_add, frame_adds = [], []
                for s_idx in range(s0):
                    for l_idx, link in enumerate(
                            optimizers[s_idx].ReferencedLinks()):
                        body_name = link.body_ptr.name
                        if body_name not in gt:
                            continue
                        pose = c2w @ b2c[i_run * s0 + s_idx, l_idx]
                        pose_gt = gt[body_name][frame + 1]
                        add = metrics.add_error(vertices[body_name], pose,
                                                pose_gt)
                        adds = metrics.adds_error(vertices[body_name], pose,
                                                  pose_gt, kdtrees[body_name])
                        frame_add.append(metrics.auc_from_error(add, threshold))
                        frame_adds.append(metrics.auc_from_error(adds,
                                                                 threshold))
                if frame_add:
                    res = results[run]
                    res["add_aucs"].append(float(np.mean(frame_add)))
                    res["adds_aucs"].append(float(np.mean(frame_adds)))
                    res["cycle_times"].append(elapsed / r)
            frame += 1
            for i_run in range(r):
                if not active[i_run]:
                    continue
                if frame + 1 >= n_frames[i_run]:
                    active[i_run] = False
                    continue
                ok = color_cams[i_run].UpdateImage()
                if use_depth:
                    ok = depth_cams[i_run].UpdateImage() and ok
                if not ok:
                    active[i_run] = False

        out = {}
        for run, res in results.items():
            self._save_run_poses(object_name, run, saved[run])
            out[run] = {
                "add_auc": float(np.mean(res["add_aucs"]))
                if res["add_aucs"] else 0.0,
                "adds_auc": float(np.mean(res["adds_aucs"]))
                if res["adds_aucs"] else 0.0,
                "mean_cycle_time_s": float(np.mean(res["cycle_times"]))
                if res["cycle_times"] else 0.0,
                "n_frames": len(res["add_aucs"]),
            }
        return out

    def _evaluate_sequence(self, tracker, object_name, difficulty, depth_name,
                           seq) -> dict:
        sequence_base = os.path.join(self.dataset_directory, object_name,
                                     difficulty, f"{seq:03d}")
        color_dir = os.path.join(sequence_base, "rgb")
        depth_dir = os.path.join(sequence_base, depth_name)
        gt_dir = os.path.join(sequence_base, "poses_gt")
        # SetRunConfiguration (rtb_evaluator.cpp:713-740): consume each loader
        # camera's metafile once, then redirect it into the run's directories
        # (SetUp would otherwise re-read load_directory from the metafile).
        tracker._assemble_derived_object_ptrs()  # populate camera_ptrs pre-SetUp
        self.tracker_setter(tracker)
        for camera in tracker.camera_ptrs:
            if not hasattr(camera, "load_directory"):
                continue
            if camera.metafile_path:
                camera._load_loader_metadata(
                    require_depth_scale=isinstance(camera, LoaderDepthCamera))
                camera.metafile_path = None
            camera.load_directory = (depth_dir
                                     if isinstance(camera, LoaderDepthCamera)
                                     else color_dir)
            camera.load_index = 0
        if not tracker.SetUp():
            raise RuntimeError("tracker failed to set up")

        bodies = {b.name: b for b in tracker.body_ptrs}
        gt_poses = self._load_gt_poses(gt_dir, list(bodies))
        vertices = {}
        kdtrees = {}
        multiplier = OBJECT2SIZE_MULTIPLIER.get(object_name, 1.0)
        for body_name in gt_poses:
            body = bodies[body_name]
            v = metrics.reduce_vertices(body.triangle_vertices_f_body().reshape(-1, 3))
            vertices[body_name] = v
            kdtrees[body_name] = cKDTree(v)

        # Initialize structures from GT at frame 0 through the configured detectors.
        for detector in tracker.detector_ptrs:
            root_body = detector.optimizer_ptr.root_link_ptr.body_ptr
            if root_body is not None and root_body.name in gt_poses:
                detector.link2world_pose = gt_poses[root_body.name][0]

        tracker.names_detecting = set(tracker.names_all)
        tracker.names_starting = set(tracker.names_all)
        tracker._validate_names()
        tracker._assemble_internally_used_object_ptrs()

        add_aucs = []
        adds_aucs = []
        cycle_times = []
        saved = {name: [] for name in bodies}
        n_frames = min(len(p) for p in gt_poses.values()) if gt_poses else 0
        for i in range(max(n_frames - 1, 0)):
            if not tracker.UpdateCameras(i):
                break
            tracker.CalculateConsistentPoses()
            tracker.ExecuteDetectingStep(i)
            tracker.ExecuteStartingStep(i)
            begin = time.perf_counter()
            tracker.ExecuteTrackingStep(i)
            cycle_times.append(time.perf_counter() - begin)
            if self.save_poses_folder:
                for body_name, body in bodies.items():
                    saved[body_name].append(
                        np.asarray(body.body2world_pose).copy())
            frame_add = []
            frame_adds = []
            threshold = THRESHOLD_MAX * multiplier
            for body_name, poses in gt_poses.items():
                body = bodies[body_name]
                add = metrics.add_error(vertices[body_name], body.body2world_pose,
                                        poses[i + 1])
                adds = metrics.adds_error(vertices[body_name], body.body2world_pose,
                                          poses[i + 1], kdtrees[body_name])
                frame_add.append(metrics.auc_from_error(add, threshold))
                frame_adds.append(metrics.auc_from_error(adds, threshold))
            if frame_add:
                add_aucs.append(float(np.mean(frame_add)))
                adds_aucs.append(float(np.mean(frame_adds)))

        self._save_run_poses(object_name, (difficulty, depth_name, seq), saved)
        return {
            "add_auc": float(np.mean(add_aucs)) if add_aucs else 0.0,
            "adds_auc": float(np.mean(adds_aucs)) if adds_aucs else 0.0,
            "mean_cycle_time_s": float(np.mean(cycle_times)) if cycle_times else 0.0,
            "n_frames": len(add_aucs),
        }

    def SaveResults(self, path: str) -> None:  # noqa: N802
        """CSV rows "<title>,add_auc,adds_auc,cycle_time" per run plus an "all"
        average row (rtb_evaluator.cpp:267-279)."""
        with open(path, "w") as f:
            for key, r in self.results.get("per_run", {}).items():
                title = "_".join(str(k) for k in key)
                f.write(f"{title},{r['add_auc']},{r['adds_auc']},"
                        f"{r.get('mean_cycle_time_s', 0.0)}\n")
            f.write(f"all,{self.results.get('add_auc', 0.0)},"
                    f"{self.results.get('adds_auc', 0.0)},"
                    f"{np.mean([r.get('mean_cycle_time_s', 0.0) for r in self.results.get('per_run', {}).values()]) if self.results.get('per_run') else 0.0}\n")
