"""DepthModality component (port of m3t_tpu/depth_modality.py; reference
m3t/src/depth_modality.cpp), over the batched ``ops/depth_fn`` correspondences and
Gauss-Newton terms called with a batch of one body.

Both are graphed as the JAX package jits them (``_correspondences_jit``,
``_gradient_hessian_jit``, graphs.py), without JAX's ``has_*`` flags (an absent input is
None, keyed by type); the point count and ``handle_occlusions`` are (1,) tensors and the
intrinsics and depth scale floats keyed by value, as in region_modality.py."""

from __future__ import annotations

import numpy as np
import torch

from m3t_tpu_torch import graphs, pipeline
from m3t_tpu_torch.common import resolve_device, to_numpy
from m3t_tpu_torch.modality import Modality
from m3t_tpu_torch.ops import depth_fn
from m3t_tpu_torch.ops.depth_fn import (DepthConfig, DepthModeledOcclusionInputs,
                                         DepthViewPoints, SilhouetteCheckInputs)
from m3t_tpu_torch.region_modality import f32_intrinsics, shared_model_arrays, view_rows
from m3t_tpu_torch.utils import yaml_io


@graphs.graphed(static_argnames=("cfg", "considered_distance", "width", "height",
                                 "measure_occlusions"))
def _correspondences_jit(cfg, considered_distance, width, height, measure_occlusions,
                         points, n_points, body2camera_pose, depth_image, intrin,
                         depth_scale, handle_occlusions, modeled, silhouette):
    return depth_fn.calculate_correspondences(
        cfg, considered_distance, points, n_points, body2camera_pose, depth_image, *intrin,
        width, height, depth_scale, handle_occlusions,
        measure_occlusions=measure_occlusions, modeled_occlusion=modeled,
        silhouette_check=silhouette)


@graphs.graphed(static_argnames=("standard_deviation",))
def _gradient_hessian_jit(standard_deviation, points, body2camera_pose):
    return depth_fn.calculate_gradient_and_hessian(points, body2camera_pose,
                                                   standard_deviation)


class DepthModality(Modality):
    def __init__(self, name: str, body_ptr, depth_camera_ptr, depth_model_ptr,
                 metafile_path: str | None = None, device="cuda"):
        super().__init__(name, body_ptr, metafile_path)
        self.device = resolve_device(device)
        self.depth_camera_ptr = depth_camera_ptr
        self.depth_model_ptr = depth_model_ptr

        # Parameters (defaults: depth_modality.h:302-321)
        self.n_points_max = 200
        self.use_adaptive_coverage = False
        self.use_depth_scaling = False
        self.reference_surface_area = 0.0
        self.stride_length = 0.005
        self.considered_distances = [0.05, 0.02, 0.01]
        self.standard_deviations = [0.05, 0.03, 0.02]

        self.use_silhouette_checking = False
        self.measure_occlusions = False
        self.measured_depth_offset_radius = 0.01
        self.measured_occlusion_radius = 0.01
        self.measured_occlusion_threshold = 0.03
        self.model_occlusions = False
        self.modeled_depth_offset_radius = 0.01
        self.modeled_occlusion_radius = 0.01
        self.modeled_occlusion_threshold = 0.03
        self.n_unoccluded_iterations = 10
        self.min_n_unoccluded_points = 0

        self.depth_renderer_ptr = None
        self.silhouette_renderer_ptr = None

        # Visualization flags (depth_modality.h:151-170).
        self.visualize_correspondences_correspondence = False
        self.visualize_points_correspondence = False
        self.visualize_points_result = False
        self.visualization_min_depth = 0.0
        self.visualization_max_depth = 1.0

        self._cfg: DepthConfig | None = None
        self.data_points = None
        self.first_iteration = 0
        self._points: DepthViewPoints | None = None
        self._n_points = 0
        self._considered_distance = 0.05
        self._standard_deviation = 0.05

    # -- configuration -----------------------------------------------------------------

    def MeasureOcclusions(self) -> None:  # noqa: N802
        self.measure_occlusions = True
        self.set_up = False

    def ModelOcclusions(self, depth_renderer_ptr) -> None:  # noqa: N802
        self.depth_renderer_ptr = depth_renderer_ptr
        self.model_occlusions = True
        self.set_up = False

    def UseSilhouetteChecking(self, silhouette_renderer_ptr) -> None:  # noqa: N802
        self.silhouette_renderer_ptr = silhouette_renderer_ptr
        self.use_silhouette_checking = True
        self.set_up = False

    def _load_metadata(self) -> bool:
        fs = yaml_io.open_yaml_file_storage(self.metafile_path)

        def g(key, cur):
            return yaml_io.read_optional(fs, key, cur)

        self.n_points_max = int(g("n_points", self.n_points_max))
        self.use_adaptive_coverage = bool(g("use_adaptive_coverage",
                                            self.use_adaptive_coverage))
        self.use_depth_scaling = bool(g("use_depth_scaling", self.use_depth_scaling))
        self.reference_surface_area = float(g("reference_surface_area",
                                              self.reference_surface_area))
        self.stride_length = float(g("stride_length", self.stride_length))
        cds = g("considered_distances", None)
        if cds is not None:
            self.considered_distances = [float(v) for v in cds]
        stds = g("standard_deviations", None)
        if stds is not None:
            self.standard_deviations = [float(v) for v in stds]
        self.measured_depth_offset_radius = float(g(
            "measured_depth_offset_radius", self.measured_depth_offset_radius))
        self.measured_occlusion_radius = float(g("measured_occlusion_radius",
                                                 self.measured_occlusion_radius))
        self.measured_occlusion_threshold = float(g(
            "measured_occlusion_threshold", self.measured_occlusion_threshold))
        self.modeled_depth_offset_radius = float(g(
            "modeled_depth_offset_radius", self.modeled_depth_offset_radius))
        self.modeled_occlusion_radius = float(g("modeled_occlusion_radius",
                                                self.modeled_occlusion_radius))
        self.modeled_occlusion_threshold = float(g(
            "modeled_occlusion_threshold", self.modeled_occlusion_threshold))
        self.n_unoccluded_iterations = int(g("n_unoccluded_iterations",
                                             self.n_unoccluded_iterations))
        self.min_n_unoccluded_points = int(g("min_n_unoccluded_points",
                                             self.min_n_unoccluded_points))
        return True

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            if not self._load_metadata():
                return False
        required = [("body", self.body_ptr), ("depth camera", self.depth_camera_ptr),
                    ("depth model", self.depth_model_ptr)]
        if self.model_occlusions:
            required.append(("depth renderer", self.depth_renderer_ptr))
        if self.use_silhouette_checking:
            required.append(("silhouette renderer", self.silhouette_renderer_ptr))
        for label, ptr in required:
            if ptr is None or not ptr.set_up:
                print(f"{label} for depth modality {self.name} was not set up")
                return False

        m = self.depth_model_ptr
        stride = m.stride_depth_offset
        n_offsets = m.depth_offsets.shape[-1]
        self.measured_depth_offset_id = min(
            int(self.measured_depth_offset_radius / stride + 0.5), n_offsets - 1)
        self.modeled_depth_offset_id = min(
            int(self.modeled_depth_offset_radius / stride + 0.5), n_offsets - 1)

        self._cfg = DepthConfig(
            n_points_max=self.n_points_max,
            use_depth_scaling=self.use_depth_scaling,
            stride_length=self.stride_length,
            measured_occlusion_radius=self.measured_occlusion_radius,
            measured_occlusion_threshold=self.measured_occlusion_threshold,
            modeled_occlusion_radius=self.modeled_occlusion_radius,
            modeled_occlusion_threshold=self.modeled_occlusion_threshold,
            min_n_unoccluded_points=self.min_n_unoccluded_points,
        )
        self._model_arrays = shared_model_arrays(
            pipeline.DepthModelArrays, m, self.n_points_max, self.device,
            self.measured_depth_offset_id, self.modeled_depth_offset_id)
        self.set_up = True
        return True

    # -- helpers -----------------------------------------------------------------------

    def _body2camera_pose(self) -> np.ndarray:
        return self.depth_camera_ptr.world2camera_pose @ self.body_ptr.body2world_pose

    def _tensor(self, a):
        """A host array, or a tensor on any device (a renderer's image), on the
        modality's device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _fetch_view(self):
        """The closest view's points and the budget (cpp:252-315); returns the
        body2camera pose as a (1, 4, 4) tensor."""
        pose = self._body2camera_pose()
        m = self.depth_model_ptr
        idx = m.GetClosestViewIndex(pose)
        if self.use_adaptive_coverage:
            area = float(m.surface_areas[idx])
            if self.reference_surface_area > 0.0:
                ratio = min(1.0, area / self.reference_surface_area)
            else:
                ratio = area / m.max_surface_area if m.max_surface_area > 0 else 1.0
            n_points = int(self.n_points_max * ratio)
        else:
            n_points = self.n_points_max
        available = m.centers.shape[1]
        if n_points > available:
            print(f"Number of model points too small: {available} < {n_points}")
            n_points = available
        a = self._model_arrays  # (1, V, P, 3) points, (1, V, P) offsets
        self._points = DepthViewPoints(**view_rows(dict(
            center_f_body=a.centers[0, idx], normal_f_body=a.normals[0, idx],
            measured_depth_offset=a.measured_depth_offsets[0, idx],
            modeled_depth_offset=a.modeled_depth_offsets[0, idx]), self.n_points_max))
        self._n_points = n_points
        return self._tensor(pose)[None]

    def _iteration_values(self, corr_iteration: int):
        cd = self.considered_distances[
            min(corr_iteration, len(self.considered_distances) - 1)]
        std = self.standard_deviations[
            min(corr_iteration, len(self.standard_deviations) - 1)]
        return float(cd), float(std)

    def _scene_inputs(self):
        """The modeled-occlusion and silhouette inputs that are switched on (else
        None), each a batch of one."""
        modeled = silhouette = None
        if self.model_occlusions:
            r = self.depth_renderer_ptr
            modeled = DepthModeledOcclusionInputs(
                focused_depth=self._tensor(r.focused_depth_image())[None],
                corner_u=self._tensor([r.corner_u]).float(),
                corner_v=self._tensor([r.corner_v]).float(),
                scale=self._tensor([r.scale]).float(),
                body_visible=self._tensor([r.IsBodyVisible(self.body_ptr.name)]))
        if self.use_silhouette_checking:
            r = self.silhouette_renderer_ptr
            silhouette = SilhouetteCheckInputs(
                silhouette=self._tensor(r.focused_silhouette_image())[None].to(torch.int32),
                corner_u=self._tensor([r.corner_u]).float(),
                corner_v=self._tensor([r.corner_v]).float(),
                scale=self._tensor([r.scale]).float(),
                body_id=self._tensor([self.body_ptr.body_id]).to(torch.int32),
                body_visible=self._tensor([r.IsBodyVisible(self.body_ptr.name)]))
        return modeled, silhouette

    # -- protocol ----------------------------------------------------------------------

    def StartModality(self, iteration: int, corr_iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up depth modality {self.name} first")
            return False
        self.first_iteration = iteration
        return True

    def CalculateCorrespondences(self, iteration: int, corr_iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up depth modality {self.name} first")
            return False
        self._considered_distance, self._standard_deviation = \
            self._iteration_values(corr_iteration)
        pose = self._fetch_view()
        cam = self.depth_camera_ptr
        intr = cam.intrinsics
        handle_occlusions = (iteration - self.first_iteration
                             ) >= self.n_unoccluded_iterations
        modeled, silhouette = self._scene_inputs()
        self.data_points = _correspondences_jit(
            self._cfg, self._considered_distance, intr.width, intr.height,
            self.measure_occlusions, self._points,
            torch.tensor([self._n_points], dtype=torch.int32, device=self.device), pose,
            self._tensor(cam.image)[None], f32_intrinsics(intr),
            float(np.float32(cam.depth_scale)),
            torch.tensor([handle_occlusions], device=self.device), modeled, silhouette)
        return True

    def CalculateGradientAndHessian(self, iteration: int, corr_iteration: int,
                                    opt_iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up depth modality {self.name} first")
            return False
        gradient, hessian = _gradient_hessian_jit(
            self._standard_deviation, self.data_points,
            self._tensor(self._body2camera_pose())[None])
        self.gradient, self.hessian = gradient[0], hessian[0]
        return True

    def CalculateResults(self, iteration: int) -> bool:  # noqa: N802
        return self.set_up

    # -- visualization (depth_modality.cpp:317-331, 383-395) ---------------------------

    def _depth_points_image(self, draw_correspondences: bool) -> np.ndarray:
        import cv2

        from m3t_tpu_torch.utils import visualization

        cam = self.depth_camera_ptr
        intr = cam.intrinsics
        base = cv2.cvtColor(cam.NormalizedDepthImage(self.visualization_min_depth,
                                                     self.visualization_max_depth),
                            cv2.COLOR_GRAY2BGR)
        pose = self._body2camera_pose()
        valid = to_numpy(self.data_points.valid[0])
        centers = to_numpy(self.data_points.center_f_body[0])[valid]
        visualization.draw_points(base, centers @ pose[:3, :3].T + pose[:3, 3], intr.fu,
                                  intr.fv, intr.ppu, intr.ppv)
        if draw_correspondences:
            corr = to_numpy(self.data_points.correspondence_center_f_camera[0])[valid]
            visualization.draw_points(base, corr, intr.fu, intr.fv, intr.ppu, intr.ppv,
                                      color=(61, 63, 179))
        return base

    def _show(self, title: str, save_idx: int, image) -> None:
        from m3t_tpu_torch.utils import visualization

        visualization.show_and_save_image(
            f"{self.name}_{title}", save_idx, image, self.display_visualization,
            self.save_visualizations, self.save_directory, self.save_image_type)

    def _visualizing(self) -> bool:
        return ((self.display_visualization or self.save_visualizations)
                and self.data_points is not None)

    def VisualizeCorrespondences(self, save_idx: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        if not self._visualizing():
            return True
        if self.visualize_correspondences_correspondence:
            self._show("correspondences_correspondence", save_idx,
                       self._depth_points_image(True))
        if self.visualize_points_correspondence:
            self._show("depth_image_correspondence", save_idx,
                       self._depth_points_image(False))
        return True

    def VisualizeResults(self, save_idx: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        if self.visualize_pose_result:
            print(f"body2world_pose {self.name}:\n{self.body_ptr.body2world_pose}")
        if not self._visualizing():
            return True
        if self.visualize_points_result:
            self._show("depth_image_result", save_idx, self._depth_points_image(False))
        return True

    # -- referenced objects ------------------------------------------------------------

    def camera_ptrs(self) -> list:
        return [self.depth_camera_ptr]

    def model_ptr(self):
        return self.depth_model_ptr

    def _renderers(self) -> list:
        out = []
        if self.model_occlusions and self.depth_renderer_ptr:
            out.append(self.depth_renderer_ptr)
        if self.use_silhouette_checking and self.silhouette_renderer_ptr:
            out.append(self.silhouette_renderer_ptr)
        return out

    def start_modality_renderer_ptrs(self) -> list:
        return self._renderers()

    def correspondence_renderer_ptrs(self) -> list:
        return self._renderers()

    def results_renderer_ptrs(self) -> list:
        return self._renderers()
