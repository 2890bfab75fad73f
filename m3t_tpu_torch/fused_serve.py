"""Fused serve mode for the reference-shaped Tracker (port of m3t_tpu/fused_serve.py).

The object-graph Tracker (tracker.py) mirrors the reference's per-modality serve loop
(tracker.cpp:221-262).  :class:`FusedServeBackend` replaces that loop's whole
``ExecuteTrackingStep`` + ``CalculateResults`` sequence (tracker.cpp:344-364) by one
``pipeline.tracking_cycle`` or ``tracking_cycle_rgbd`` call over every tracked body (the
card's kernels: ``sample_lines`` and ``bin_counts``, and ``sample_windows`` with depth)
when the tracked graph is a batch of independent rigid bodies on one colour (and
optionally one depth) camera, and writes the poses and histograms back into the object
graph, so that detectors, refiners, viewers and publishers keep working on live state.

The model arrays are the modalities' own device copies, batched (expanded over the
bodies when they share a model).  Per step the frame is uploaded once and handed to the
cycle as a view expanded over the batch.  Graphs the backend cannot express (kinematic
trees, renderers, shared histograms, visualization, modalities on several devices) fall
back to the host path with a printed notice; the reasons are the JAX package's.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from m3t_tpu_torch import pipeline
from m3t_tpu_torch.common import to_numpy
from m3t_tpu_torch.depth_modality import DepthModality
from m3t_tpu_torch.region_modality import RegionModality, f32_intrinsics
from m3t_tpu_torch.utils import timing


def _batch_models(arrays):
    """One batch of the bodies' model arrays, each the batch of one that its modality
    shares with the other modalities over its model (region_modality.
    shared_model_arrays): the distinct copies concatenated once, views zero-padded to
    the largest V, then expanded over the bodies (a view) when they share one model,
    else indexed by body."""
    distinct = list({id(a): a for a in arrays}.values())
    slot = {id(a): i for i, a in enumerate(distinct)}
    v_max = max(a.orientations.shape[1] for a in distinct)

    def padded(t):  # (1, V, ...) -> (1, v_max, ...); (1,) as it is
        if t.dim() < 2 or t.shape[1] == v_max:
            return t
        return torch.cat([t, t.new_zeros((1, v_max - t.shape[1]) + t.shape[2:])], 1)

    batch = type(distinct[0])(*(torch.cat([padded(t) for t in field])
                                for field in zip(*distinct)))
    if len(distinct) == 1:
        return batch.expand(len(arrays))
    index = torch.tensor([slot[id(a)] for a in arrays], device=batch.orientations.device)
    return type(batch)(*(t[index] for t in batch))


class FusedServeBackend:
    """One fused tracking step per cycle for a set of rigid-body optimizers."""

    def __init__(self, tracker, optimizers, region_modalities, depth_modalities,
                 pcfg, model_arrays, depth_model_arrays, intr, depth_intr,
                 depth_scale, color_camera, depth_camera, device):
        self.tracker = tracker
        self.optimizers = optimizers
        self.region_modalities = region_modalities
        self.depth_modalities = depth_modalities
        self.pcfg = pcfg
        self.model_arrays = model_arrays
        self.depth_model_arrays = depth_model_arrays
        self.intr = intr
        self.depth_intr = depth_intr
        self.depth_scale = depth_scale
        self.color_camera = color_camera
        self.depth_camera = depth_camera
        self.device = device

    # -- expressibility check + construction -------------------------------------------

    @classmethod
    def try_build(cls, tracker):
        """Build a backend for the tracker's CURRENT tracking set, or return a
        (None, reason) pair when the graph is not expressible."""
        optimizers = list(tracker.tracking_optimizer_ptrs)
        if not optimizers:
            return None, "no tracking optimizers"

        region_modalities = []
        depth_modalities = []
        eye = np.eye(4, dtype=np.float32)
        for opt in optimizers:
            if opt.constraint_ptrs or opt.soft_constraint_ptrs:
                return None, f"optimizer {opt.name} has constraints"
            links = opt.ReferencedLinks()
            if len(links) != 1:
                return None, f"optimizer {opt.name} is a kinematic tree"
            link = links[0]
            if not np.allclose(link.body2joint_pose, eye):
                return None, f"link {link.name} has a non-identity body2joint"
            if not all(link.free_directions):
                return None, f"link {link.name} pins directions"
            rms = [m for m in link.modality_ptrs if isinstance(m, RegionModality)]
            dms = [m for m in link.modality_ptrs if isinstance(m, DepthModality)]
            if len(rms) != 1 or len(link.modality_ptrs) != len(rms) + len(dms):
                return None, (f"link {link.name} needs exactly one region "
                              f"modality (+ optional depth modality)")
            if len(dms) > 1:
                return None, f"link {link.name} has several depth modalities"
            for m in rms + dms:
                if m.model_occlusions:
                    return None, f"modality {m.name} models occlusions"
                if any(v for k, v in vars(m).items() if k.startswith("visualize")):
                    return None, f"modality {m.name} visualizes"
            rm = rms[0]
            if rm.use_region_checking:
                return None, f"modality {rm.name} uses region checking"
            if rm.use_shared_color_histograms:
                return None, f"modality {rm.name} shares histograms"
            if dms and dms[0].use_silhouette_checking:
                return None, f"modality {dms[0].name} checks silhouettes"
            region_modalities.append(rm)
            depth_modalities.append(dms[0] if dms else None)

        devices = {m.device for m in region_modalities + depth_modalities if m is not None}
        if len(devices) != 1:
            return None, f"modalities on several devices {sorted(map(str, devices))}"
        device = devices.pop()

        rm0 = region_modalities[0]
        color_camera = rm0.color_camera_ptr
        for rm in region_modalities:
            if rm.color_camera_ptr is not color_camera:
                return None, "several color cameras"
            if rm._cfg != rm0._cfg or list(rm.scales) != list(rm0.scales) \
                    or list(rm.standard_deviations) != list(rm0.standard_deviations) \
                    or rm.measure_occlusions != rm0.measure_occlusions \
                    or rm.use_adaptive_coverage != rm0.use_adaptive_coverage \
                    or rm.reference_contour_length != rm0.reference_contour_length \
                    or rm.learning_rate_f != rm0.learning_rate_f \
                    or rm.learning_rate_b != rm0.learning_rate_b \
                    or rm.n_unoccluded_iterations != rm0.n_unoccluded_iterations:
                return None, "region modality parameters differ across bodies"

        use_depth = all(m is not None for m in depth_modalities)
        if not use_depth and any(m is not None for m in depth_modalities):
            return None, "depth modality on some bodies only"
        depth_camera = None
        dm0 = None
        if use_depth:
            dm0 = depth_modalities[0]
            depth_camera = dm0.depth_camera_ptr
            for dm in depth_modalities:
                if dm.depth_camera_ptr is not depth_camera:
                    return None, "several depth cameras"
                if dm._cfg != dm0._cfg \
                        or list(dm.considered_distances) != list(dm0.considered_distances) \
                        or list(dm.standard_deviations) != list(dm0.standard_deviations) \
                        or dm.measure_occlusions != dm0.measure_occlusions \
                        or dm.n_unoccluded_iterations != dm0.n_unoccluded_iterations:
                    return None, "depth modality parameters differ across bodies"
        if rm0.measure_occlusions:
            if not use_depth:
                return None, "region measured occlusions need a depth camera"
            if rm0.depth_camera_ptr is not depth_camera:
                return None, "region/depth modalities use different depth cameras"
        if use_depth and dm0.n_unoccluded_iterations != rm0.n_unoccluded_iterations:
            return None, "region/depth n_unoccluded_iterations differ"
        if use_depth and not np.allclose(
                np.asarray(depth_camera.world2camera_pose),
                np.asarray(color_camera.world2camera_pose), atol=1e-7):
            # tracking_cycle_rgbd evaluates depth terms in the color camera's
            # frame; offset depth extrinsics need the host path.
            return None, "depth camera extrinsics differ from color camera"

        opt0 = optimizers[0]
        for opt in optimizers:
            if (opt.tikhonov_parameter_rotation != opt0.tikhonov_parameter_rotation
                    or opt.tikhonov_parameter_translation
                    != opt0.tikhonov_parameter_translation):
                return None, "tikhonov parameters differ across optimizers"

        pcfg = pipeline.PipelineConfig(
            cfg=rm0._cfg, scales=tuple(rm0.scales),
            standard_deviations=tuple(rm0.standard_deviations),
            n_corr_iterations=tracker.n_corr_iterations,
            n_update_iterations=tracker.n_update_iterations,
            tikhonov_rotation=float(opt0.tikhonov_parameter_rotation),
            tikhonov_translation=float(opt0.tikhonov_parameter_translation),
            learning_rate_f=float(rm0.learning_rate_f),
            learning_rate_b=float(rm0.learning_rate_b),
            use_depth=use_depth,
            region_measure_occlusions=bool(rm0.measure_occlusions),
            use_adaptive_coverage=bool(rm0.use_adaptive_coverage),
            reference_contour_length=float(rm0.reference_contour_length))
        if use_depth:
            pcfg = pcfg._replace(
                depth_cfg=dm0._cfg,
                considered_distances=tuple(dm0.considered_distances),
                depth_standard_deviations=tuple(dm0.standard_deviations),
                depth_measure_occlusions=bool(dm0.measure_occlusions))

        model_arrays = _batch_models([m._model_arrays for m in region_modalities])
        depth_model_arrays = depth_intr = depth_scale = None
        if use_depth:
            depth_model_arrays = _batch_models([m._model_arrays for m in depth_modalities])
            depth_intr = f32_intrinsics(depth_camera.intrinsics)
            depth_scale = float(np.float32(depth_camera.depth_scale))
        return cls(tracker, optimizers, region_modalities, depth_modalities, pcfg,
                   model_arrays, depth_model_arrays, f32_intrinsics(color_camera.intrinsics),
                   depth_intr, depth_scale, color_camera, depth_camera, device), None

    # -- per-cycle execution ------------------------------------------------------------

    def _gather_state(self):
        w2c = np.asarray(self.color_camera.world2camera_pose, np.float32)
        poses = np.stack([w2c @ opt.ReferencedLinks()[0].body_ptr.body2world_pose
                          for opt in self.optimizers]).astype(np.float32)
        hist_f = torch.stack([m.color_histograms_ptr.histogram_f
                              for m in self.region_modalities])
        hist_b = torch.stack([m.color_histograms_ptr.histogram_b
                              for m in self.region_modalities])
        return pipeline.TrackingState(torch.as_tensor(poses, device=self.device),
                                      hist_f, hist_b)

    def _scatter_state(self, state):
        c2w = np.asarray(self.color_camera.camera2world_pose, np.float32)
        poses = state.body2camera_pose.cpu().numpy()
        for i, opt in enumerate(self.optimizers):
            opt.ReferencedLinks()[0].set_link2world_pose(c2w @ poses[i])
        for i, m in enumerate(self.region_modalities):
            m.color_histograms_ptr.histogram_f = state.histogram_f[i]
            m.color_histograms_ptr.histogram_b = state.histogram_b[i]

    def _frames(self, image, planar: bool):
        """The camera's frame uploaded once, as a view expanded over the batch."""
        frame = torch.as_tensor(np.asarray(image), device=self.device)
        if planar:
            frame = frame.permute(2, 0, 1).contiguous()
        return frame.expand((len(self.optimizers),) + frame.shape)

    def Execute(self, iteration: int) -> bool:  # noqa: N802
        """One fused tracking step == ExecuteTrackingStep + CalculateResults (spans
        ``serve.gather``, ``serve.frames``, ``serve.cycle``, ``serve.scatter``)."""
        with timing.span("serve.gather"):
            state = self._gather_state()
        with timing.span("serve.frames"):
            images = self._frames(self.color_camera.image, planar=True)
            depth_images = None
            if self.pcfg.use_depth:
                depth_images = self._frames(self.depth_camera.image, planar=False)
            handle_occlusions = torch.tensor([
                iteration - m.first_iteration >= m.n_unoccluded_iterations
                for m in self.region_modalities], device=self.device)
        with timing.span("serve.cycle"):
            if self.pcfg.use_depth:
                state = pipeline.tracking_cycle_rgbd(
                    self.pcfg, self.intr, self.depth_intr, self.depth_scale, images,
                    depth_images, self.model_arrays, self.depth_model_arrays, state,
                    handle_occlusions=handle_occlusions)
            else:
                state = pipeline.tracking_cycle(self.pcfg, self.intr, images,
                                                self.model_arrays, state,
                                                handle_occlusions=handle_occlusions)
        with timing.span("serve.scatter"):
            self._scatter_state(state)
        return True


def read_graph_state(tracker) -> dict:
    """What a tracking step of ``tracker``'s graph starts from, as host numpy keyed by
    object name: every link's joint poses and pose (``links``), every region modality's
    histograms (``histograms``) and every TextureModality's keyframes, detections and
    keyframe bookkeeping (``keyframes``).  It reads attributes only, so it takes a
    Tracker of the JAX package as well; :func:`load_graph_state` writes the result into
    a port graph of the same names."""
    state = {"links": {}, "histograms": {}, "keyframes": {}}

    def host(x):
        return None if x is None else to_numpy(x)

    for opt in tracker.optimizer_ptrs:
        for link in opt.ReferencedLinks():
            state["links"][link.name] = tuple(
                host(p) for p in (link.body2joint_pose, link.joint2parent_pose,
                                  link.link2world_pose))
            for m in link.modality_ptrs:
                if hasattr(m, "_points_keyframes"):
                    state["keyframes"][m.name] = dict(
                        points=[host(p) for p in m._points_keyframes],
                        descriptors=[host(d) for d in m._descriptors_keyframes],
                        keypoints=host(m._keypoints), descriptors_now=host(m._descriptors),
                        orientation=host(m._orientation_last_keyframe),
                        age=int(m.keyframe_age))
                elif getattr(m, "color_histograms_ptr", None) is not None:
                    hist = m.color_histograms_ptr
                    state["histograms"][m.name] = (host(hist.histogram_f),
                                                   host(hist.histogram_b))
    return state


def load_graph_state(tracker, state: dict) -> None:
    """Write :func:`read_graph_state`'s result into the port graph of ``tracker``: joint
    poses and link poses (the body's pose follows its link), histograms on their device,
    texture keyframes as host arrays; every one a copy, so that no two graphs share
    memory."""
    for opt in tracker.optimizer_ptrs:
        for link in opt.ReferencedLinks():
            body2joint, joint2parent, link2world = state["links"][link.name]
            link.body2joint_pose = np.asarray(body2joint, np.float32).copy()
            link.joint2parent_pose = np.asarray(joint2parent, np.float32).copy()
            link.set_link2world_pose(np.asarray(link2world, np.float32).copy())
            for m in link.modality_ptrs:
                if m.name in state["keyframes"]:
                    kf = state["keyframes"][m.name]
                    m._points_keyframes = collections.deque(
                        np.array(p, np.float32) for p in kf["points"])
                    m._descriptors_keyframes = collections.deque(
                        None if d is None else np.array(d) for d in kf["descriptors"])
                    m._keypoints = np.array(kf["keypoints"], np.float32)
                    m._descriptors = (None if kf["descriptors_now"] is None
                                      else np.array(kf["descriptors_now"]))
                    m._orientation_last_keyframe = np.array(kf["orientation"])
                    m.keyframe_age = kf["age"]
                elif m.name in state["histograms"]:
                    hist = m.color_histograms_ptr
                    hist.histogram_f, hist.histogram_b = (
                        torch.tensor(np.asarray(h, np.float32), device=hist.device)
                        for h in state["histograms"][m.name])
