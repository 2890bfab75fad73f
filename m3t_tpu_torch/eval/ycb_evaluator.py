"""YCB-Video dataset evaluator (port of m3t_tpu/eval/ycb_evaluator.py; reference
M3T/examples/ycb_evaluator.{h,cpp}).

RGB-D region+depth(+texture) tracking over YCB-Video sequences 48-59 with ADD / ADD-S
AUC metrics (threshold curve 0-0.1 m, ADD-S via KD-tree nearest vertex,
ycb_evaluator.h:46,65-68) evaluated on keyframes; initial poses come from an external
detector (cosypose/posecnn folders, evaluate_ycb_dataset.cpp:118).

Expected layout:
  <dataset>/data/<seq:04d>/<frame:06d>-color.png, -depth.png
  <dataset>/image_sets/keyframe.txt              lines "<seq:04d>/<frame:06d>"
  <dataset>/models/<body>/textured.obj
  <external>/poses/<detector>/<seq>_<body>.txt   lines "qw qx qy qz tx ty tz" per keyframe
  <external>/poses/gt/<seq>_<body>.txt           same format, ground truth

Every tensor lives on ``device`` (the card unless the caller asks for the CPU): the
modalities and renderers of the host path, and the model arrays, frames and state of
the fused path.  The texture modality's feature matching stays on the host (cv2).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
from scipy.spatial import cKDTree

from m3t_tpu_torch import pipeline
from m3t_tpu_torch.body import Body
from m3t_tpu_torch.camera import LoaderColorCamera, LoaderDepthCamera
from m3t_tpu_torch.common import Intrinsics, resolve_device, to_numpy
from m3t_tpu_torch.depth_modality import DepthModality
from m3t_tpu_torch.depth_model import DepthModel
from m3t_tpu_torch.detector import StaticDetector
from m3t_tpu_torch.eval import metrics
from m3t_tpu_torch.link import Link
from m3t_tpu_torch.optimizer import Optimizer
from m3t_tpu_torch.refiner import Refiner
from m3t_tpu_torch.region_modality import RegionModality
from m3t_tpu_torch.region_model import RegionModel
from m3t_tpu_torch.renderer import FocusedSilhouetteRenderer, IDType
from m3t_tpu_torch.renderer_geometry import RendererGeometry
from m3t_tpu_torch.texture_modality import TextureModality
from m3t_tpu_torch.tracker import Tracker

YCB_INTRINSICS = Intrinsics(1066.778, 1067.487, 312.9869, 241.3109, 640, 480)
N_CURVE_VALUES = 100
THRESHOLD_MAX = 0.1


def read_quaternion_poses(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Lines of "qw qx qy qz tx ty tz"; returns (poses (N,4,4), valid (N,))."""
    from scipy.spatial.transform import Rotation

    poses = []
    valid = []
    with open(path, "r") as f:
        for line in f:
            values = [float(v) for v in line.split()]
            if len(values) < 7 or not np.isfinite(values).all():
                poses.append(np.eye(4, dtype=np.float32))
                valid.append(False)
                continue
            qw, qx, qy, qz, tx, ty, tz = values[:7]
            pose = np.eye(4, dtype=np.float32)
            pose[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
            pose[:3, 3] = [tx, ty, tz]
            poses.append(pose)
            valid.append(True)
    return np.asarray(poses, np.float32), np.asarray(valid, bool)


class YCBEvaluator:
    def __init__(self, name: str, dataset_directory: str, external_directory: str,
                 sequence_ids: list[int], sequence2body_names: dict[int, list[str]],
                 detector_folder: str = "cosypose",
                 multi_region_body_names: list[str] | None = None,
                 device="cuda"):
        self.name = name
        self.device = resolve_device(device)
        self.dataset_directory = str(dataset_directory)
        self.external_directory = str(external_directory)
        self.sequence_ids = list(sequence_ids)
        self.sequence2body_names = dict(sequence2body_names)
        self.detector_folder = detector_folder
        self.use_region_modality = True
        self.use_depth_modality = True
        self.use_texture_modality = False
        self.use_matlab_gt_poses = False
        self.run_sequentially = True
        # Multi-region variants (evaluate_ycb_dataset.cpp:35-44,124): bodies in
        # this list are split into sub-body regions (OBJ files under
        # <external>/multi_region/<body>/), one RegionModel per sub-body with
        # the other sub-bodies associated as different-region geometry
        # (ycb_evaluator.cpp:1109-1126), and one RegionModality per sub-model
        # all summing into the body's single Link.
        self.multi_region_body_names = list(multi_region_body_names or [])
        self.use_multi_region = bool(multi_region_body_names)
        self.depth_scale = 0.0001  # YCB-Video factor_depth = 10000
        self.intrinsics = YCB_INTRINSICS
        # Throughput path (DEFAULT): every (sequence, body) run tracks as
        # ONE batch through pipeline.tracking_cycle_rgbd (the analogue of the
        # reference's `#pragma omp parallel for` over sequences,
        # ycb_evaluator.cpp:210).  Keyframe metrics, detector initialization and
        # (optional) host texture features stay host-side.  Set False for the
        # object-graph parity path.
        self.use_fused_pipeline = True
        self.pipeline_config = None  # Optional m3t_tpu_torch.pipeline.PipelineConfig
        # Refinement evaluation (ycb_evaluator.cpp:317-345): instead of
        # tracking, every keyframe resets the bodies to the external detector
        # poses and scores one Refiner pass against GT (host path only).
        self.evaluate_refinement = False
        self.refiner_setter = lambda r: None
        # Setter hooks (evaluate_ycb_dataset.cpp:46-117)
        self.tracker_setter = lambda t: None
        self.region_modality_setter = lambda m: None
        self.region_model_setter = lambda m: None
        self.depth_modality_setter = lambda m: None
        self.depth_model_setter = lambda m: None
        self.texture_modality_setter = lambda m: None
        self.results: dict = {}
        self.set_up = False

    def SetUp(self) -> bool:  # noqa: N802
        self.keyframes: dict[int, list[int]] = {s: [] for s in self.sequence_ids}
        keyframe_path = os.path.join(self.dataset_directory, "image_sets",
                                     "keyframe.txt")
        if os.path.exists(keyframe_path):
            with open(keyframe_path, "r") as f:
                for line in f:
                    seq_s, frame_s = line.strip().split("/")
                    seq = int(seq_s)
                    if seq in self.keyframes:
                        self.keyframes[seq].append(int(frame_s))
        self.set_up = True
        return True

    # -- object construction -----------------------------------------------------------

    def _make_body(self, body_name: str) -> Body:
        body = Body(
            body_name,
            geometry_path=os.path.join(self.dataset_directory, "models", body_name,
                                       "textured.obj"),
            geometry_unit_in_meter=1.0, geometry_counterclockwise=True,
            geometry_enable_culling=True)
        if not body.SetUp():
            raise RuntimeError(f"Could not set up body {body_name}")
        return body

    def _is_multi_region(self, body_name: str) -> bool:
        return self.use_multi_region and body_name in self.multi_region_body_names

    def _load_sub_bodies(self, body_name: str) -> list[Body]:
        """Sub-body region meshes from <external>/multi_region/<body_name>/
        (ycb_evaluator.cpp:1079-1099)."""
        directory = os.path.join(self.external_directory, "multi_region",
                                 body_name)
        sub_bodies = []
        for fname in sorted(os.listdir(directory)):
            if not fname.lower().endswith(".obj"):
                continue
            sub = Body(os.path.splitext(fname)[0],
                       geometry_path=os.path.join(directory, fname),
                       geometry_unit_in_meter=1.0,
                       geometry_counterclockwise=True,
                       geometry_enable_culling=True)
            if not sub.SetUp():
                raise RuntimeError(
                    f"Could not set up sub body {fname} of {body_name}")
            sub_bodies.append(sub)
        if not sub_bodies:
            raise RuntimeError(
                f"multi_region directory for {body_name} has no .obj files")
        return sub_bodies

    def _make_models(self, body: Body):
        """(list of region models, depth model) — one region model per sub-body
        for multi-region bodies (ycb_evaluator.cpp:1109-1126), else one for the
        body itself."""
        region_models = []
        if self._is_multi_region(body.name):
            sub_bodies = self._load_sub_bodies(body.name)
            for sub in sub_bodies:
                model = RegionModel(
                    f"{sub.name}_region_model", sub,
                    os.path.join(self.external_directory, "models",
                                 f"{sub.name}_region_model.npz"))
                for other in sub_bodies:
                    if other.name != sub.name:
                        model.AddAssociatedBody(other, False, False)
                self.region_model_setter(model)
                if not model.SetUp():
                    raise RuntimeError(
                        f"region model for sub body {sub.name} failed")
                region_models.append(model)
        else:
            region_model = RegionModel(
                f"{body.name}_region_model", body,
                os.path.join(self.external_directory, "models",
                             f"{body.name}_region_model.npz"))
            self.region_model_setter(region_model)
            if not region_model.SetUp():
                raise RuntimeError(f"region model for {body.name} failed")
            region_models.append(region_model)
        depth_model = None
        if self.use_depth_modality:
            depth_model = DepthModel(
                f"{body.name}_depth_model", body,
                os.path.join(self.external_directory, "models",
                             f"{body.name}_depth_model.npz"))
            self.depth_model_setter(depth_model)
            if not depth_model.SetUp():
                raise RuntimeError(f"depth model for {body.name} failed")
        return region_models, depth_model

    def _setup_tracker(self, sequence_id: int, bodies: dict, models: dict):
        sequence_dir = os.path.join(self.dataset_directory, "data",
                                    f"{sequence_id:04d}")
        color_camera = LoaderColorCamera(
            "color_camera", load_directory=sequence_dir, intrinsics=self.intrinsics,
            image_name_pre="", load_index=1, n_leading_zeros=6,
            image_name_post="-color", load_image_type="png")
        if not color_camera.SetUp():
            raise RuntimeError("color camera failed")
        depth_camera = None
        if self.use_depth_modality:
            depth_camera = LoaderDepthCamera(
                "depth_camera", load_directory=sequence_dir,
                intrinsics=self.intrinsics, depth_scale=self.depth_scale,
                image_name_pre="", load_index=1, n_leading_zeros=6,
                image_name_post="-depth", load_image_type="png")
            if not depth_camera.SetUp():
                raise RuntimeError("depth camera failed")

        rg = RendererGeometry("renderer_geometry", device=self.device)
        for body in bodies.values():
            rg.AddBody(body)

        tracker = Tracker("tracker", synchronize_cameras=False)
        optimizers = {}
        for body_name, body in bodies.items():
            region_models, depth_model = models[body_name]
            link = Link(f"{body_name}_link", body)
            silhouette_renderer = None
            if self.use_texture_modality:
                silhouette_renderer = FocusedSilhouetteRenderer(
                    f"{body_name}_silhouette_renderer", rg, color_camera,
                    id_type=IDType.BODY, device=self.device)
                silhouette_renderer.AddReferencedBody(body)
            if self.use_region_modality:
                # One RegionModality per region model (one per sub-body for
                # multi-region variants, ycb_evaluator.cpp:427-453), all
                # attached to the SAME body and link.  reference_contour_length
                # is wired like ycb_evaluator.cpp:438: it only takes effect if
                # the region_modality_setter enables use_adaptive_coverage
                # (the reference flagship sets it false,
                # evaluate_ycb_dataset.cpp:125).
                max_contour = max(m.max_contour_length for m in region_models)
                for region_model in region_models:
                    modality = RegionModality(
                        f"{region_model.body_ptr.name}_region_modality", body,
                        color_camera, region_model, device=self.device)
                    self.region_modality_setter(modality)
                    modality.reference_contour_length = max_contour
                    if depth_camera is not None:
                        modality.MeasureOcclusions(depth_camera)
                    link.AddModality(modality)
            if self.use_depth_modality and depth_camera is not None:
                modality = DepthModality(f"{body_name}_depth_modality", body,
                                         depth_camera, depth_model, device=self.device)
                self.depth_modality_setter(modality)
                modality.MeasureOcclusions()
                link.AddModality(modality)
            if self.use_texture_modality:
                modality = TextureModality(f"{body_name}_texture_modality", body,
                                           color_camera, silhouette_renderer)
                self.texture_modality_setter(modality)
                link.AddModality(modality)
            optimizer = Optimizer(f"{body_name}_optimizer", link)
            detector = StaticDetector(f"{body_name}_detector", optimizer)
            tracker.AddOptimizer(optimizer)
            tracker.AddDetector(detector)
            optimizers[body_name] = (optimizer, detector)
        self.tracker_setter(tracker)
        if not tracker.SetUp():
            raise RuntimeError("tracker failed")
        return tracker, optimizers, color_camera, depth_camera

    # -- evaluation --------------------------------------------------------------------

    def Evaluate(self) -> dict:  # noqa: N802
        if not self.set_up:
            self.SetUp()
        if self.use_fused_pipeline and not self.evaluate_refinement:
            return self._evaluate_fused()
        if self.use_fused_pipeline and self.evaluate_refinement:
            print("YCBEvaluator: refinement evaluation runs on the host path")
        all_results = {}
        for sequence_id in self.sequence_ids:
            body_names = self.sequence2body_names[sequence_id]
            bodies = {n: self._make_body(n) for n in body_names}
            models = {n: self._make_models(b) for n, b in bodies.items()}
            seq_results = self._evaluate_sequence(sequence_id, bodies, models)
            all_results[sequence_id] = seq_results
            for body_name, r in seq_results.items():
                print(f"seq {sequence_id} {body_name}: "
                      f"ADD AUC = {r['add_auc']:.4f}, ADD-S AUC = {r['adds_auc']:.4f}")
        flat = [r for seq in all_results.values() for r in seq.values()]
        self.results = {
            "per_sequence": all_results,
            "add_auc": float(np.mean([r["add_auc"] for r in flat])) if flat else 0.0,
            "adds_auc": float(np.mean([r["adds_auc"] for r in flat])) if flat else 0.0,
        }
        print(f"YCB average: ADD AUC = {self.results['add_auc']:.4f}, "
              f"ADD-S AUC = {self.results['adds_auc']:.4f}")
        return self.results

    # -- fused throughput path ---------------------------------------------------------

    def _fused_pipeline_config(self):
        pcfg = self.pipeline_config or pipeline.PipelineConfig(
            region_measure_occlusions=self.use_depth_modality,
            depth_measure_occlusions=self.use_depth_modality)
        # Modality presence is decided by the evaluator flags (the host path wires
        # modalities the same way, _setup_tracker).
        return pcfg._replace(use_depth=self.use_depth_modality,
                             use_texture=self.use_texture_modality)

    def _make_texture_modality(self, entry_name: str, body: Body, color_camera):
        rg = RendererGeometry(f"{entry_name}_rg", device=self.device)
        rg.AddBody(body)
        if not rg.SetUp():
            raise RuntimeError("renderer geometry failed")
        silhouette_renderer = FocusedSilhouetteRenderer(
            f"{entry_name}_silhouette_renderer", rg, color_camera,
            id_type=IDType.BODY, device=self.device)
        silhouette_renderer.AddReferencedBody(body)
        if not silhouette_renderer.SetUp():
            raise RuntimeError("silhouette renderer failed")
        modality = TextureModality(f"{entry_name}_texture_modality", body,
                                   color_camera, silhouette_renderer)
        self.texture_modality_setter(modality)
        if not modality.SetUp():
            raise RuntimeError("texture modality failed")
        return modality

    def _evaluate_fused(self) -> dict:
        """All (sequence, body) runs as ONE batch through tracking_cycle_rgbd.

        The device executes the full RGB-D cycle (region lines + depth points +
        measured occlusions + optional texture GN terms) for every run at once;
        the host streams frames, feeds detector initializations, runs the OpenCV
        feature path for texture keyframes, and evaluates ADD/ADD-S on keyframes
        exactly like the object-graph path (ycb_evaluator.cpp:210 parallel loop +
        evaluate_ycb_dataset.cpp:46-117 configuration)."""
        dev = self.device
        pcfg = self._fused_pipeline_config()
        n_lines = pcfg.cfg.n_lines_max
        entries = [(seq, body_name) for seq in self.sequence_ids
                   for body_name in self.sequence2body_names[seq]]

        bodies = {}
        models = {}
        for _, body_name in entries:
            if body_name not in bodies:
                bodies[body_name] = self._make_body(body_name)
                models[body_name] = self._make_models(bodies[body_name])

        # Batch slots: one per (entry, region model).  Multi-region bodies
        # contribute one slot per sub-body region model; every slot of an entry
        # shares the entry's pose through pose_group (the fused analogue of K
        # RegionModalities summing into one Link, ycb_evaluator.cpp:427-453).
        # The entry's single DepthModality lives on the first (primary) slot;
        # non-primary slots run with a zero depth point budget.
        slot_entry = []      # slot -> entry index
        slot_models = []     # slot -> region model
        slot_primary = []    # slot -> bool
        for e_idx, (seq, body_name) in enumerate(entries):
            for k, rm in enumerate(models[body_name][0]):
                slot_entry.append(e_idx)
                slot_models.append(rm)
                slot_primary.append(k == 0)
        b = len(slot_entry)
        first_slot = {}
        group = np.zeros(b, np.int32)
        for si, e_idx in enumerate(slot_entry):
            first_slot.setdefault(e_idx, si)
            group[si] = first_slot[e_idx]
        entry_slot = [first_slot[e] for e in range(len(entries))]
        slot_seq = [entries[e][0] for e in slot_entry]

        sequence_dirs = {
            seq: os.path.join(self.dataset_directory, "data", f"{seq:04d}")
            for seq in self.sequence_ids}
        color_cams = {}
        depth_cams = {}
        for seq in self.sequence_ids:
            cam = LoaderColorCamera(
                f"color_camera_{seq}", load_directory=sequence_dirs[seq],
                intrinsics=self.intrinsics, image_name_pre="", load_index=1,
                n_leading_zeros=6, image_name_post="-color",
                load_image_type="png")
            if not cam.SetUp():
                raise RuntimeError(f"color camera for sequence {seq} failed")
            color_cams[seq] = cam
            if self.use_depth_modality:
                dcam = LoaderDepthCamera(
                    f"depth_camera_{seq}", load_directory=sequence_dirs[seq],
                    intrinsics=self.intrinsics, depth_scale=self.depth_scale,
                    image_name_pre="", load_index=1, n_leading_zeros=6,
                    image_name_post="-depth", load_image_type="png")
                if not dcam.SetUp():
                    raise RuntimeError(f"depth camera for sequence {seq} failed")
                depth_cams[seq] = dcam

        region_arrays = pipeline.RegionModelArrays.from_models(
            slot_models, n_lines, device=dev)
        depth_arrays = None
        depth_n_points = None
        if self.use_depth_modality:
            depth_arrays = pipeline.DepthModelArrays.from_models(
                [models[entries[e][1]][1] for e in slot_entry],
                pcfg.depth_cfg.n_points_max, device=dev)
            depth_n_points = torch.as_tensor(np.where(
                slot_primary, pcfg.depth_cfg.n_points_max, 0).astype(np.int32),
                device=dev)
        pose_group = torch.as_tensor(group, device=dev)
        intr = (np.float32(self.intrinsics.fu), np.float32(self.intrinsics.fv),
                np.float32(self.intrinsics.ppu), np.float32(self.intrinsics.ppv))

        gt_poses = {e: self._load_poses("gt", *e) for e in entries}
        det_poses = {e: self._load_poses(self.detector_folder, *e)
                     for e in entries}
        init_poses_entries = np.stack([
            det_poses[e][0][0] if len(det_poses[e][0]) else np.eye(4, np.float32)
            for e in entries]).astype(np.float32)
        init_poses = init_poses_entries[slot_entry]

        texture_modalities = None
        if self.use_texture_modality:
            # One TextureModality per entry, on the primary slot; non-primary
            # slots carry no texture terms (None placeholder).
            texture_modalities = []
            for si, e_idx in enumerate(slot_entry):
                if not slot_primary[si]:
                    texture_modalities.append(None)
                    continue
                seq, body_name = entries[e_idx]
                texture_modalities.append(self._make_texture_modality(
                    f"{seq:04d}_{body_name}", bodies[body_name],
                    color_cams[seq]))

        vertices = {}
        kdtrees = {}
        for body_name, body in bodies.items():
            v = metrics.reduce_vertices(
                body.vertices @ body.geometry2body_pose[:3, :3].T
                + body.geometry2body_pose[:3, 3])
            vertices[body_name] = v
            kdtrees[body_name] = cKDTree(v)

        results = {e: {"add_aucs": [], "adds_aucs": [],
                       "add_curve": np.zeros(N_CURVE_VALUES),
                       "adds_curve": np.zeros(N_CURVE_VALUES),
                       "cycle_times": []} for e in entries}
        keyframe_idx = {seq: 0 for seq in self.sequence_ids}
        active = {seq: True for seq in self.sequence_ids}
        started = False
        state = None
        frame = 0

        class _NoTexture:
            data_points_3d = ()
            data_points_2d = ()

        def batch_images():
            color = np.stack([np.asarray(color_cams[seq].image)
                              for seq in slot_seq])
            depth = None
            if self.use_depth_modality:
                depth = np.stack([np.asarray(depth_cams[seq].image)
                                  for seq in slot_seq])
            return (torch.as_tensor(color, device=dev),
                    torch.as_tensor(depth, device=dev) if depth is not None else None)

        def texture_points(poses_est):
            if texture_modalities is None:
                return None
            for si, m in enumerate(texture_modalities):
                if m is None:
                    continue
                body_name = entries[slot_entry[si]][1]
                bodies[body_name].set_body2world_pose(poses_est[si])
                m.CalculateCorrespondences(frame, 0)
            real = [m for m in texture_modalities if m is not None]
            k_max = max(128, max(len(m.data_points_3d) for m in real))
            return pipeline.texture_points_from_modalities(
                [m if m is not None else _NoTexture() for m in texture_modalities],
                k_max, device=dev)

        while any(active.values()) and any(
                keyframe_idx[s] < len(self.keyframes.get(s) or [])
                for s in self.sequence_ids if active[s]):
            for seq in self.sequence_ids:
                if not active[seq]:
                    continue
                ok = color_cams[seq].UpdateImage()
                if self.use_depth_modality:
                    ok = depth_cams[seq].UpdateImage() and ok
                if not ok:
                    active[seq] = False
            if not any(active.values()):
                break
            images, depth_images = batch_images()
            if not started:
                state = pipeline.initialize_histograms(
                    pcfg, intr, images, region_arrays,
                    torch.as_tensor(init_poses, device=dev))
                if texture_modalities is not None:
                    for si, m in enumerate(texture_modalities):
                        if m is None:
                            continue
                        body_name = entries[slot_entry[si]][1]
                        bodies[body_name].set_body2world_pose(init_poses[si])
                        m.StartModality(frame, 0)
                started = True
            begin = time.perf_counter()
            tex = texture_points(to_numpy(state.body2camera_pose))
            if self.use_depth_modality:
                state = pipeline.tracking_cycle_rgbd(
                    pcfg, intr, intr, np.float32(self.depth_scale), images,
                    depth_images, region_arrays, depth_arrays, state,
                    texture_points=tex, pose_group=pose_group,
                    depth_n_points=depth_n_points)
            else:
                state = pipeline.tracking_cycle(pcfg, intr, images,
                                                region_arrays, state,
                                                texture_points=tex,
                                                pose_group=pose_group)
            poses_est = to_numpy(state.body2camera_pose)
            elapsed = time.perf_counter() - begin

            for seq in self.sequence_ids:
                if not active[seq]:
                    continue
                kf = self.keyframes.get(seq) or []
                kidx = keyframe_idx[seq]
                current_frame_number = color_cams[seq].load_index - 1
                # Advance past keyframes the frame stream already passed (missing
                # frames / load_index offsets); without this a single mismatch
                # would silently stop evaluating the sequence forever.
                while kidx < len(kf) and kf[kidx] < current_frame_number:
                    print(f"YCBEvaluator: sequence {seq} keyframe {kf[kidx]} "
                          f"not seen in frame stream (now at frame "
                          f"{current_frame_number}); skipping its evaluation")
                    kidx += 1
                keyframe_idx[seq] = kidx
                if kidx >= len(kf) or current_frame_number != kf[kidx]:
                    continue
                for r, (eseq, body_name) in enumerate(entries):
                    if eseq != seq:
                        continue
                    poses_g, valid = gt_poses[(seq, body_name)]
                    if kidx >= len(poses_g) or not valid[kidx]:
                        continue
                    pose_gt = poses_g[kidx]
                    pose_e = poses_est[entry_slot[r]]
                    add = metrics.add_error(vertices[body_name], pose_e,
                                            pose_gt)
                    adds = metrics.adds_error(vertices[body_name], pose_e,
                                              pose_gt, kdtrees[body_name])
                    res = results[(seq, body_name)]
                    res["add_aucs"].append(
                        metrics.auc_from_error(add, THRESHOLD_MAX))
                    res["adds_aucs"].append(
                        metrics.auc_from_error(adds, THRESHOLD_MAX))
                    res["add_curve"] += metrics.error_curve(
                        add, THRESHOLD_MAX, N_CURVE_VALUES)
                    res["adds_curve"] += metrics.error_curve(
                        adds, THRESHOLD_MAX, N_CURVE_VALUES)
                    res["cycle_times"].append(elapsed / len(entries))
                keyframe_idx[seq] += 1
            frame += 1

        all_results = {seq: {} for seq in self.sequence_ids}
        for (seq, body_name), r in results.items():
            n = max(len(r["add_aucs"]), 1)
            all_results[seq][body_name] = {
                "add_auc": float(np.mean(r["add_aucs"])) if r["add_aucs"] else 0.0,
                "adds_auc": float(np.mean(r["adds_aucs"]))
                if r["adds_aucs"] else 0.0,
                "add_curve": (r["add_curve"] / n).tolist(),
                "adds_curve": (r["adds_curve"] / n).tolist(),
                "mean_cycle_time_s": float(np.mean(r["cycle_times"]))
                if r["cycle_times"] else 0.0,
                "n_keyframes": len(r["add_aucs"]),
            }
            print(f"seq {seq} {body_name} (fused): "
                  f"ADD AUC = {all_results[seq][body_name]['add_auc']:.4f}, "
                  f"ADD-S AUC = {all_results[seq][body_name]['adds_auc']:.4f}")
        flat = [r for seq in all_results.values() for r in seq.values()]
        self.results = {
            "per_sequence": all_results,
            "add_auc": float(np.mean([r["add_auc"] for r in flat])) if flat else 0.0,
            "adds_auc": float(np.mean([r["adds_auc"] for r in flat]))
            if flat else 0.0,
        }
        print(f"YCB average (fused): ADD AUC = {self.results['add_auc']:.4f}, "
              f"ADD-S AUC = {self.results['adds_auc']:.4f}")
        return self.results

    def _refinement_loop(self, tracker, optimizers, color_camera, depth_camera,
                         keyframes, gt_poses, detector_poses, vertices,
                         kdtrees, results) -> dict:
        """Refinement evaluation (ycb_evaluator.cpp:317-345): per keyframe,
        reset every body to the external detector pose, run one Refiner pass,
        and score the refined pose against that keyframe's GT."""
        refiner = Refiner("refiner")
        for optimizer, _ in optimizers.values():
            refiner.AddOptimizer(optimizer)
        self.refiner_setter(refiner)
        if not refiner.SetUp():
            raise RuntimeError("refiner failed to set up")
        names = {o.name for o, _ in optimizers.values()}

        for kidx, kf in enumerate(keyframes):
            # Jump the replay cameras to the keyframe (UpdateCameras with the
            # keyframe's index, cpp:339-345).
            color_camera.load_index = kf
            if not color_camera.UpdateImage():
                break
            if depth_camera is not None:
                depth_camera.load_index = kf
                if not depth_camera.UpdateImage():
                    break
            any_detected = False
            for body_name, (optimizer, detector) in optimizers.items():
                poses_det, valid = detector_poses[body_name]
                if kidx < len(poses_det) and valid[kidx]:
                    detector.link2world_pose = poses_det[kidx]
                    detector.DetectPoses({optimizer.name}, set())
                    any_detected = True
            if not any_detected:
                continue
            begin = time.perf_counter()
            if not refiner.RefinePoses(names):
                raise RuntimeError("refiner failed")
            elapsed = time.perf_counter() - begin
            for body_name, (optimizer, _) in optimizers.items():
                poses_g, valid = gt_poses[body_name]
                if kidx >= len(poses_g) or not valid[kidx]:
                    continue
                body = optimizer.root_link_ptr.body_ptr
                pose_gt = poses_g[kidx]
                add = metrics.add_error(vertices[body_name],
                                        body.body2world_pose, pose_gt)
                adds = metrics.adds_error(vertices[body_name],
                                          body.body2world_pose, pose_gt,
                                          kdtrees[body_name])
                r = results[body_name]
                r["add_aucs"].append(metrics.auc_from_error(add, THRESHOLD_MAX))
                r["adds_aucs"].append(
                    metrics.auc_from_error(adds, THRESHOLD_MAX))
                r["add_curve"] += metrics.error_curve(add, THRESHOLD_MAX,
                                                      N_CURVE_VALUES)
                r["adds_curve"] += metrics.error_curve(adds, THRESHOLD_MAX,
                                                       N_CURVE_VALUES)
                r["cycle_times"].append(elapsed)
        return self._summarize_results(results)

    @staticmethod
    def _summarize_results(results) -> dict:
        out = {}
        for body_name, r in results.items():
            n = max(len(r["add_aucs"]), 1)
            out[body_name] = {
                "add_auc": float(np.mean(r["add_aucs"])) if r["add_aucs"] else 0.0,
                "adds_auc": float(np.mean(r["adds_aucs"])) if r["adds_aucs"] else 0.0,
                "add_curve": (r["add_curve"] / n).tolist(),
                "adds_curve": (r["adds_curve"] / n).tolist(),
                "mean_cycle_time_s": float(np.mean(r["cycle_times"]))
                if r["cycle_times"] else 0.0,
                "n_keyframes": len(r["add_aucs"]),
            }
        return out

    def _load_poses(self, folder: str, sequence_id: int, body_name: str):
        path = os.path.join(self.external_directory, "poses", folder,
                            f"{sequence_id:04d}_{body_name}.txt")
        return read_quaternion_poses(path)

    def _evaluate_sequence(self, sequence_id: int, bodies: dict, models: dict) -> dict:
        tracker, optimizers, color_camera, depth_camera = self._setup_tracker(
            sequence_id, bodies, models)
        keyframes = self.keyframes.get(sequence_id) or []
        gt_poses = {}
        detector_poses = {}
        for body_name in bodies:
            gt_poses[body_name] = self._load_poses("gt", sequence_id, body_name)
            detector_poses[body_name] = self._load_poses(
                self.detector_folder, sequence_id, body_name)

        # Initialize from detector poses at the first keyframe.
        for body_name, (optimizer, detector) in optimizers.items():
            poses, valid = detector_poses[body_name]
            if len(poses) and valid[0]:
                detector.link2world_pose = poses[0]
                detector.DetectPoses({optimizer.name}, set())
        tracker.names_tracking = set(tracker.names_all)
        tracker._assemble_internally_used_object_ptrs()

        vertices = {}
        kdtrees = {}
        for body_name, body in bodies.items():
            v = metrics.reduce_vertices(
                body.vertices @ body.geometry2body_pose[:3, :3].T
                + body.geometry2body_pose[:3, 3])
            vertices[body_name] = v
            kdtrees[body_name] = cKDTree(v)

        results = {n: {"add_aucs": [], "adds_aucs": [],
                       "add_curve": np.zeros(N_CURVE_VALUES),
                       "adds_curve": np.zeros(N_CURVE_VALUES),
                       "cycle_times": []} for n in bodies}
        if self.evaluate_refinement:
            return self._refinement_loop(
                tracker, optimizers, color_camera, depth_camera, keyframes,
                gt_poses, detector_poses, vertices, kdtrees, results)
        started = False
        frame = 0
        keyframe_idx = 0
        while keyframe_idx < len(keyframes):
            if not tracker.UpdateCameras(frame):
                break
            if not started:
                tracker.StartModalities(frame)
                started = True
            begin = time.perf_counter()
            tracker.ExecuteTrackingStep(frame)
            elapsed = time.perf_counter() - begin

            current_frame_number = color_camera.load_index - 1
            while (keyframe_idx < len(keyframes)
                   and keyframes[keyframe_idx] < current_frame_number):
                print(f"YCBEvaluator: sequence {sequence_id} keyframe "
                      f"{keyframes[keyframe_idx]} not seen in frame stream "
                      f"(now at frame {current_frame_number}); skipping its "
                      f"evaluation")
                keyframe_idx += 1
            if (keyframe_idx < len(keyframes)
                    and current_frame_number == keyframes[keyframe_idx]):
                for body_name, body in bodies.items():
                    poses_gt, valid = gt_poses[body_name]
                    if keyframe_idx >= len(poses_gt) or not valid[keyframe_idx]:
                        continue
                    pose_gt = poses_gt[keyframe_idx]
                    add = metrics.add_error(vertices[body_name],
                                            body.body2world_pose, pose_gt)
                    adds = metrics.adds_error(vertices[body_name],
                                              body.body2world_pose, pose_gt,
                                              kdtrees[body_name])
                    r = results[body_name]
                    r["add_aucs"].append(metrics.auc_from_error(add, THRESHOLD_MAX))
                    r["adds_aucs"].append(metrics.auc_from_error(adds, THRESHOLD_MAX))
                    r["add_curve"] += metrics.error_curve(add, THRESHOLD_MAX,
                                                          N_CURVE_VALUES)
                    r["adds_curve"] += metrics.error_curve(adds, THRESHOLD_MAX,
                                                           N_CURVE_VALUES)
                    r["cycle_times"].append(elapsed)
                keyframe_idx += 1
            frame += 1

        return self._summarize_results(results)
