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

import numpy as np
import torch

from m3t_tpu_torch import pipeline
from m3t_tpu_torch.depth_modality import DepthModality
from m3t_tpu_torch.region_modality import RegionModality, f32_intrinsics


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
        """One fused tracking step == ExecuteTrackingStep + CalculateResults."""
        state = self._gather_state()
        images = self._frames(self.color_camera.image, planar=True)
        handle_occlusions = torch.tensor([
            iteration - m.first_iteration >= m.n_unoccluded_iterations
            for m in self.region_modalities], device=self.device)
        if self.pcfg.use_depth:
            state = pipeline.tracking_cycle_rgbd(
                self.pcfg, self.intr, self.depth_intr, self.depth_scale, images,
                self._frames(self.depth_camera.image, planar=False), self.model_arrays,
                self.depth_model_arrays, state, handle_occlusions=handle_occlusions)
        else:
            state = pipeline.tracking_cycle(self.pcfg, self.intr, images,
                                            self.model_arrays, state,
                                            handle_occlusions=handle_occlusions)
        self._scatter_state(state)
        return True


def load_tracker_state(tracker, body2world_poses, histograms_f, histograms_b) -> None:
    """Write rigid bodies' poses (N, 4, 4) and their region modalities' histograms
    (N, n_bins**3), numpy in the order of ``tracker.optimizer_ptrs``, into the links and
    ColorHistograms of the tracker's graph (on their device), through the attributes
    that the fused backend writes after each step."""
    for i, opt in enumerate(tracker.optimizer_ptrs):
        link = opt.ReferencedLinks()[0]
        link.set_link2world_pose(np.asarray(body2world_poses[i], np.float32))
        modality = next(m for m in link.modality_ptrs if isinstance(m, RegionModality))
        hist = modality.color_histograms_ptr
        hist.histogram_f = torch.as_tensor(np.asarray(histograms_f[i], np.float32),
                                           device=hist.device)
        hist.histogram_b = torch.as_tensor(np.asarray(histograms_b[i], np.float32),
                                           device=hist.device)
