"""RBOT dataset evaluator (port of m3t_tpu/eval/rbot_evaluator.py; reference
M3T/examples/rbot_evaluator.{h,cpp}).

Monocular region(+texture) tracking over RBOT sequences: 1000 frames/sequence, fixed
intrinsics 650.048/647.183 @ 640x512, success = err_t < 5 cm AND err_r < 5 deg, body
reset to ground truth on failure (which IS the metric), occlusion sequences add a second
"squirrel_small" body (rbot_evaluator.h:39-56, cpp:180-230).

Dataset layout (published RBOT format):
  <dataset>/<body>/frames/<sequence><index:04d>.png
  <dataset>/<body>/<body>.obj
  <dataset>/poses_first.txt, poses_second.txt  (rows: 9 rotation + 3 translation in mm)

Every tensor lives on ``device`` (the card unless the caller asks for the CPU): the
modalities, renderers and renderer geometry of the host path, and the model arrays,
frames, scene and state of the fused path.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from m3t_tpu_torch import pipeline
from m3t_tpu_torch.body import Body
from m3t_tpu_torch.camera import LoaderColorCamera
from m3t_tpu_torch.common import Intrinsics, resolve_device, to_numpy
from m3t_tpu_torch.detector import StaticDetector
from m3t_tpu_torch.eval import metrics
from m3t_tpu_torch.link import Link
from m3t_tpu_torch.ops import occlusion as occlusion_ops
from m3t_tpu_torch.optimizer import Optimizer
from m3t_tpu_torch.region_modality import RegionModality
from m3t_tpu_torch.region_model import RegionModel
from m3t_tpu_torch.renderer import FocusedBasicDepthRenderer, FocusedSilhouetteRenderer
from m3t_tpu_torch.renderer_geometry import RendererGeometry
from m3t_tpu_torch.texture_modality import TextureModality
from m3t_tpu_torch.tracker import Tracker

RBOT_INTRINSICS = Intrinsics(650.048, 647.183, 324.328 - 0.5, 257.323 - 0.5, 640, 512)
OCCLUSION_BODY_NAME = "squirrel_small"


def read_poses_rbot(path: str, n_frames: int) -> np.ndarray:
    """poses_first.txt format: header line, then rows of 9 rot + 3 trans (mm)
    (rbot_evaluator.cpp:562-585)."""
    poses = np.tile(np.eye(4, dtype=np.float32), (n_frames + 1, 1, 1))
    with open(path, "r") as f:
        f.readline()  # header
        for i in range(n_frames + 1):
            values = [float(v) for v in f.readline().split()]
            poses[i, :3, :3] = np.asarray(values[:9], np.float32).reshape(3, 3)
            poses[i, :3, 3] = np.asarray(values[9:12], np.float32) * 0.001
    return poses


class RBOTEvaluator:
    def __init__(self, name: str, dataset_directory: str, external_directory: str,
                 body_names: list[str], sequence_names: list[str],
                 sequence_occlusions: list[bool] | None = None,
                 n_frames: int = 1000, device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.dataset_directory = str(dataset_directory)
        self.external_directory = str(external_directory)
        self.body_names = list(body_names)
        self.sequence_names = list(sequence_names)
        self.sequence_occlusions = (sequence_occlusions
                                    or [s == "d_occlusion" for s in sequence_names])
        self.n_frames = int(n_frames)
        self.translation_error_threshold = 0.05
        self.rotation_error_threshold = 5.0 * np.pi / 180.0
        self.visualize_tracking = False
        self.use_shared_color_histograms = False
        self.use_region_checking = False
        self.use_texture_modality = False
        self.model_occlusions = False
        # Throughput path (DEFAULT): every (sequence, body) combination runs
        # as ONE batch through pipeline.tracking_cycle (the analogue of the
        # reference's `#pragma omp parallel for` over runs,
        # ycb_evaluator.cpp:210), occlusion sequences included (the
        # squirrel_small partner tracks as a hidden batch entry feeding the
        # occlusion SceneGeometry).  The reset-to-GT protocol stays host-side
        # (it IS the metric).  Set False for the object-graph parity path.
        self.use_fused_pipeline = True
        self.pipeline_config = None  # Optional m3t_tpu_torch.pipeline.PipelineConfig
        self.n_unoccluded_iterations = 10  # region_modality.h:442
        # Callables to tweak object parameters before SetUp (mirrors *_setter_ hooks).
        self.tracker_setter = lambda tracker: None
        self.region_modality_setter = lambda modality: None
        self.region_model_setter = lambda model: None
        self.texture_modality_setter = lambda modality: None
        self.intrinsics = RBOT_INTRINSICS
        self.results: dict = {}
        self.set_up = False

    def SetUp(self) -> bool:  # noqa: N802
        self.poses_gt_first = read_poses_rbot(
            os.path.join(self.dataset_directory, "poses_first.txt"), self.n_frames)
        occlusions_used = any(self.sequence_occlusions)
        self.poses_gt_second = (
            read_poses_rbot(os.path.join(self.dataset_directory, "poses_second.txt"),
                            self.n_frames)
            if occlusions_used else None)
        self.set_up = True
        return True

    # -- per-run setup (rbot_evaluator.cpp:213-330) ------------------------------------

    def _make_body(self, body_name: str) -> Body:
        body = Body(
            body_name,
            geometry_path=os.path.join(self.dataset_directory, body_name,
                                       f"{body_name}.obj"),
            geometry_unit_in_meter=0.001, geometry_counterclockwise=True,
            geometry_enable_culling=False)
        if not body.SetUp():
            raise RuntimeError(f"Could not set up body {body_name}")
        return body

    def _make_model(self, body: Body) -> RegionModel:
        model = RegionModel(
            f"{body.name}_model", body,
            os.path.join(self.external_directory, f"{body.name}_model.npz"),
            sphere_radius=0.8, n_divides=4, n_points=200,
            max_radius_depth_offset=0.01, stride_depth_offset=0.002,
            image_size=2000)
        self.region_model_setter(model)
        if not model.SetUp():
            raise RuntimeError(f"Could not set up model for {body.name}")
        return model

    def _setup_tracker(self, sequence_name: str, body_name: str, occlusions: bool,
                       models: dict):
        camera = LoaderColorCamera(
            "camera",
            load_directory=os.path.join(self.dataset_directory, body_name, "frames"),
            intrinsics=self.intrinsics, image_name_pre=sequence_name,
            load_index=0, n_leading_zeros=4)
        if not camera.SetUp():
            raise RuntimeError("Could not set up camera")

        body = self._make_body(body_name)
        rg = RendererGeometry("renderer_geometry", device=self.device)
        rg.AddBody(body)
        occlusion_body = None
        if occlusions:
            occlusion_body = self._make_body(OCCLUSION_BODY_NAME)
            rg.AddBody(occlusion_body)
        rg.SetUp()

        silhouette_renderer = FocusedSilhouetteRenderer("silhouette_renderer", rg,
                                                        camera, device=self.device)
        silhouette_renderer.AddReferencedBody(body)
        if occlusions:
            silhouette_renderer.AddReferencedBody(occlusion_body)
        silhouette_renderer.SetUp()
        depth_renderer = None
        if occlusions and self.model_occlusions:
            depth_renderer = FocusedBasicDepthRenderer("depth_renderer", rg, camera,
                                                       device=self.device)
            depth_renderer.AddReferencedBody(body)
            depth_renderer.AddReferencedBody(occlusion_body)
            depth_renderer.SetUp()

        def build_link(b: Body) -> Link:
            modality = RegionModality(f"{b.name}_region_modality", b, camera,
                                      models[b.name], device=self.device)
            self.region_modality_setter(modality)
            if occlusions and self.model_occlusions and depth_renderer is not None:
                modality.ModelOcclusions(depth_renderer)
            link = Link(f"{b.name}_link", b)
            link.AddModality(modality)
            if self.use_texture_modality:
                texture_modality = TextureModality(
                    f"{b.name}_texture_modality", b, camera, silhouette_renderer)
                self.texture_modality_setter(texture_modality)
                link.AddModality(texture_modality)
            return link

        tracker = Tracker("tracker", synchronize_cameras=False)
        optimizers = {}
        for b in [body] + ([occlusion_body] if occlusions else []):
            link = build_link(b)
            optimizer = Optimizer(f"{b.name}_optimizer", link)
            detector = StaticDetector(f"{b.name}_detector", optimizer)
            tracker.AddOptimizer(optimizer)
            tracker.AddDetector(detector)
            optimizers[b.name] = (optimizer, detector)
        self.tracker_setter(tracker)
        if not tracker.SetUp():
            raise RuntimeError("Could not set up tracker")
        return tracker, body, occlusion_body, optimizers, camera

    def _reset_body(self, tracker, optimizers, body_name: str, poses_gt, frame: int):
        optimizer, detector = optimizers[body_name]
        detector.link2world_pose = poses_gt[frame]
        detector.DetectPoses({optimizer.name}, set())
        tracker.StartModalities(frame)

    # -- evaluation (cpp:140-210) ------------------------------------------------------

    def Evaluate(self) -> dict:  # noqa: N802
        if not self.set_up:
            self.SetUp()
        results = {}
        # Precompute models once per body.
        bodies = {name: self._make_body(name) for name in set(
            self.body_names + ([OCCLUSION_BODY_NAME]
                               if any(self.sequence_occlusions) else []))}
        models = {name: self._make_model(body) for name, body in bodies.items()}

        fused_runs = []
        for sequence_name, occlusions in zip(self.sequence_names,
                                             self.sequence_occlusions):
            for body_name in self.body_names:
                if self.use_fused_pipeline:
                    fused_runs.append((sequence_name, body_name, occlusions))
                    continue
                result = self._evaluate_sequence(sequence_name, body_name,
                                                 occlusions, models)
                results[(sequence_name, body_name)] = result
                print(f"{sequence_name} {body_name}: "
                      f"success = {result['tracking_success']:.4f}")
        if fused_runs:
            for run, result in self._evaluate_fused(fused_runs, models).items():
                results[run] = result
                print(f"{run[0]} {run[1]} (fused): "
                      f"success = {result['tracking_success']:.4f}")
        success = float(np.mean([r["tracking_success"] for r in results.values()]))
        mean_time = float(np.mean([r["mean_cycle_time_s"] for r in results.values()]))
        self.results = {"per_run": results, "tracking_success": success,
                        "mean_cycle_time_s": mean_time}
        print(f"RBOT average tracking success: {success:.4f}")
        return self.results

    def _evaluate_sequence(self, sequence_name: str, body_name: str,
                           occlusions: bool, models: dict) -> dict:
        tracker, body, occlusion_body, optimizers, camera = self._setup_tracker(
            sequence_name, body_name, occlusions, models)
        tracker.names_tracking = set(tracker.names_all)
        tracker._assemble_internally_used_object_ptrs()

        # Initialize to GT for frame 0 and start modalities.
        self._reset_body(tracker, optimizers, body_name, self.poses_gt_first, 0)
        if occlusions:
            self._reset_body(tracker, optimizers, OCCLUSION_BODY_NAME,
                             self.poses_gt_second, 0)

        successes = []
        translation_errors = []
        rotation_errors = []
        cycle_times = []
        for i in range(self.n_frames):
            if not tracker.UpdateCameras(i):
                break
            begin = time.perf_counter()
            tracker.ExecuteTrackingStep(i)
            cycle_times.append(time.perf_counter() - begin)

            pose_gt = self.poses_gt_first[i + 1]
            pose = body.body2world_pose
            t_err = metrics.translation_error(pose, pose_gt)
            r_err = metrics.rotation_error(pose, pose_gt)
            success = (t_err <= self.translation_error_threshold
                       and r_err <= self.rotation_error_threshold)
            successes.append(float(success))
            translation_errors.append(t_err)
            rotation_errors.append(r_err)
            if not success:
                # Reset to ground truth on failure (the RBOT protocol, cpp:199).
                self._reset_body(tracker, optimizers, body_name,
                                 self.poses_gt_first, i + 1)
            if occlusions:
                occ_success = metrics.tracking_success(
                    occlusion_body.body2world_pose, self.poses_gt_second[i + 1],
                    self.translation_error_threshold, self.rotation_error_threshold)
                if not occ_success:
                    self._reset_body(tracker, optimizers, OCCLUSION_BODY_NAME,
                                     self.poses_gt_second, i + 1)

        return {
            "tracking_success": float(np.mean(successes)) if successes else 0.0,
            "mean_translation_error": float(np.mean(translation_errors)),
            "mean_rotation_error": float(np.mean(rotation_errors)),
            "mean_cycle_time_s": float(np.mean(cycle_times)),
            "n_frames": len(successes),
        }

    def _evaluate_fused(self, runs, models) -> dict:
        """All runs — regular AND occlusion sequences — as one fused batch.

        One pipeline.tracking_cycle call per frame covers every (sequence, body)
        run at once; per-frame success, reset-to-GT (pose + histogram re-init),
        and error bookkeeping happen host-side exactly as in _evaluate_sequence.
        Occlusion sequences add a hidden batch entry tracking the
        "squirrel_small" body (rbot_evaluator.h:42) on the same frames; when
        ``model_occlusions`` / ``use_region_checking`` are set, each occlusion
        entry carries a SceneGeometry [own body, partner body] and the partner's
        pose (from the previous cycle's estimate — the only divergence from the
        host path, which re-renders at the in-cycle estimate) feeds the
        per-iteration modeled-occlusion / region checks
        (rbot_evaluator.cpp:202-208).  The reference's n_unoccluded_iterations
        grace period after every (re)start is honored per entry through the
        per-body handle_occlusions input.
        """
        dev = self.device
        use_scene = self.model_occlusions or self.use_region_checking
        pcfg = self.pipeline_config or pipeline.PipelineConfig()
        if use_scene:
            pcfg = pcfg._replace(
                region_model_occlusions=self.model_occlusions,
                region_checking=self.use_region_checking)
        n_lines = pcfg.cfg.n_lines_max
        n_unoccluded_iterations = self.n_unoccluded_iterations

        # Batch entries: every run, plus a hidden partner entry per occlusion run.
        entries = []  # (sequence_name, body_name, gt_key, partner_idx, hidden)
        for sequence_name, body_name, occlusions in runs:
            main_idx = len(entries)
            entries.append([sequence_name, body_name, "first", None, False])
            if occlusions:
                partner_idx = len(entries)
                entries.append([sequence_name, body_name, "second", main_idx,
                                True])
                entries[main_idx][3] = partner_idx
        b = len(entries)

        cameras = []
        for sequence_name, body_name, _, _, _ in entries:
            camera = LoaderColorCamera(
                f"camera_{sequence_name}_{body_name}",
                load_directory=os.path.join(self.dataset_directory, body_name,
                                            "frames"),
                intrinsics=self.intrinsics, image_name_pre=sequence_name,
                load_index=0, n_leading_zeros=4)
            if not camera.SetUp():
                raise RuntimeError(f"Could not set up camera for {sequence_name}")
            cameras.append(camera)

        def entry_body_name(e):
            return OCCLUSION_BODY_NAME if e[2] == "second" else e[1]

        def entry_gt(e):
            return (self.poses_gt_second if e[2] == "second"
                    else self.poses_gt_first)

        arrays = pipeline.RegionModelArrays.from_models(
            [models[entry_body_name(e)] for e in entries], n_lines, device=dev)
        intr = (np.float32(self.intrinsics.fu), np.float32(self.intrinsics.fv),
                np.float32(self.intrinsics.ppu), np.float32(self.intrinsics.ppv))

        scene_geom = None
        if use_scene:
            # Scene slot 0 = tracked body, slot 1 = partner (occlusion entries)
            # or an invalidated padding slot (regular entries).
            body_cache: dict[str, object] = {}

            def scene_body(name):
                if name not in body_cache:
                    body_cache[name] = self._make_body(name)
                return body_cache[name]

            scenes = []
            has_partner = []
            for e in entries:
                own = scene_body(entry_body_name(e))
                if e[3] is not None:
                    partner = scene_body(entry_body_name(entries[e[3]]))
                    scenes.append([own, partner])
                    has_partner.append(True)
                else:
                    scenes.append([own])
                    has_partner.append(False)
            # Occlusion checks need only coarse geometry (cm-scale thresholds);
            # decimate like the reference's renderer geometry does for its
            # occlusion meshes.
            scene_geom = occlusion_ops.build_scene_geometry(scenes,
                                                            decimate_to=512,
                                                            device=dev)
            # Regular entries carry no occlusion scene in the host path (no
            # focused renderers are built for them, _setup_tracker): mask their
            # triangles/references so body_visible == False and every check
            # passes through.
            mask = torch.as_tensor(has_partner, device=dev)
            scene_geom = scene_geom._replace(
                tri_valid=scene_geom.tri_valid & mask[:, None],
                ref_valid=scene_geom.ref_valid & mask[:, None])

        def batch_images():
            return torch.as_tensor(np.stack([np.asarray(c.image) for c in cameras]),
                                   device=dev)

        def occluder_pose_array(poses_est):
            if scene_geom is None:
                return None
            parked = np.eye(4, dtype=np.float32)
            parked[2, 3] = -10.0  # MoveBackPoses parking slot (tracker.cpp:394)
            occ = np.stack([
                poses_est[e[3]] if e[3] is not None else parked for e in entries])
            return torch.as_tensor(occ[:, None], device=dev)

        # SetUp loaded frame 0 on every camera: StartModalities at GT pose 0.
        images = batch_images()
        init_poses = torch.as_tensor(np.stack([entry_gt(e)[0] for e in entries]),
                                     device=dev)
        state = pipeline.initialize_histograms(pcfg, intr, images, arrays,
                                               init_poses)
        frames_since_start = np.zeros(b, np.int64)

        stats = [{"successes": [], "translation_errors": [], "rotation_errors": [],
                  "cycle_times": []} for _ in entries]
        n_visible = sum(1 for e in entries if not e[4])
        for i in range(self.n_frames):
            ok = all(c.UpdateImage() for c in cameras)
            if not ok:
                break
            images = batch_images()
            begin = time.perf_counter()
            poses_prev = to_numpy(state.body2camera_pose)
            handle_occ = torch.as_tensor(
                frames_since_start >= n_unoccluded_iterations, device=dev)
            state = pipeline.tracking_cycle(
                pcfg, intr, images, arrays, state, scene_geom=scene_geom,
                occluder_poses=occluder_pose_array(poses_prev),
                handle_occlusions=handle_occ)
            poses_est = to_numpy(state.body2camera_pose)
            elapsed = time.perf_counter() - begin
            frames_since_start += 1

            reset_mask = np.zeros(b, bool)
            reset_poses = np.zeros((b, 4, 4), np.float32)
            for r, e in enumerate(entries):
                pose_gt = entry_gt(e)[i + 1]
                t_err = metrics.translation_error(poses_est[r], pose_gt)
                r_err = metrics.rotation_error(poses_est[r], pose_gt)
                success = (t_err <= self.translation_error_threshold
                           and r_err <= self.rotation_error_threshold)
                stats[r]["successes"].append(float(success))
                stats[r]["translation_errors"].append(t_err)
                stats[r]["rotation_errors"].append(r_err)
                stats[r]["cycle_times"].append(elapsed / n_visible)
                reset_mask[r] = not success
                reset_poses[r] = pose_gt
            if reset_mask.any():
                # Reset failed runs: GT pose + histogram re-initialization on the
                # current frame (the fused StartModalities analogue).
                reset_state = pipeline.initialize_histograms(
                    pcfg, intr, images, arrays, torch.as_tensor(reset_poses, device=dev))
                mask = torch.as_tensor(reset_mask, device=dev)
                state = pipeline.TrackingState(
                    torch.where(mask[:, None, None], reset_state.body2camera_pose,
                                state.body2camera_pose),
                    torch.where(mask[:, None], reset_state.histogram_f,
                                state.histogram_f),
                    torch.where(mask[:, None], reset_state.histogram_b,
                                state.histogram_b))
                frames_since_start[reset_mask] = 0

        return {
            (e[0], e[1]): {
                "tracking_success": float(np.mean(s["successes"]))
                if s["successes"] else 0.0,
                "mean_translation_error": float(np.mean(s["translation_errors"])),
                "mean_rotation_error": float(np.mean(s["rotation_errors"])),
                "mean_cycle_time_s": float(np.mean(s["cycle_times"])),
                "n_frames": len(s["successes"]),
            }
            for e, s in zip(entries, stats) if not e[4]
        }

    def SaveResults(self, path: str) -> None:  # noqa: N802
        import json

        with open(path, "w") as f:
            serializable = {
                f"{seq}/{body}": r
                for (seq, body), r in self.results.get("per_run", {}).items()
            }
            serializable["tracking_success"] = self.results.get("tracking_success")
            json.dump(serializable, f, indent=2)
