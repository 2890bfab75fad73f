"""RegionModality component (port of m3t_tpu/region_modality.py; reference
m3t/src/region_modality.cpp, the core tracker).

Wires the host path's functions in :mod:`m3t_tpu_torch.ops.region_fn` (called with a
batch of one body) to a body, a colour camera, a sparse-viewpoint model, histograms and,
optionally, a depth camera for measured occlusions.  Per-frame state is a ``DataLines``
of tensors on the modality's device; gradients and Hessians stay there until the Link
reads them.  The fused serve path (fused_serve.py) reads the configuration only.

The three functions are graphed as the JAX package jits them (``_correspondences_jit``,
``_gradient_hessian_jit``, ``_add_colors_jit``, graphs.py): one CUDA graph per static key
on the card, shared by every body of the same shapes.  JAX's ``has_*`` flags are left
out: an absent input is None, which the key tells apart by type.  The line count and
``handle_occlusions``, which JAX traces, are (1,) tensors, so that one graph serves every
value; the intrinsics are floats keyed by value (one graph per camera).
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from m3t_tpu_torch import graphs, pipeline
from m3t_tpu_torch.common import resolve_device, to_numpy
from m3t_tpu_torch.modality import Modality
from m3t_tpu_torch.ops import region_fn
from m3t_tpu_torch.ops.region_fn import (MeasuredOcclusionInputs, ModeledOcclusionInputs,
                                          RegionCheckInputs, RegionConfig, ViewPoints)
from m3t_tpu_torch.utils import visualization, yaml_io

_VISUALIZATION_FLAGS = (
    "visualize_pose_result", "visualize_gradient_optimization",
    "visualize_hessian_optimization", "visualize_lines_correspondence",
    "visualize_points_correspondence", "visualize_points_histogram_image_correspondence",
    "visualize_points_optimization", "visualize_points_histogram_image_optimization",
    "visualize_points_result", "visualize_points_histogram_image_result",
    "display_visualization", "save_visualizations")


@graphs.graphed(static_argnames=("cfg", "scale", "width", "height"))
def _correspondences_jit(cfg, scale, width, height, points, n_lines, body2camera_pose,
                         color_image, hist_f, hist_b, intrin, handle_occlusions, measured,
                         modeled, region_check, lookup_f, lookup_b):
    return region_fn.calculate_correspondences(
        cfg, scale, points, n_lines, body2camera_pose, color_image, hist_f, hist_b,
        *intrin, width, height, handle_occlusions, measured_occlusion=measured,
        modeled_occlusion=modeled, region_check=region_check, function_lookup_f=lookup_f,
        function_lookup_b=lookup_b)


@graphs.graphed(static_argnames=("cfg", "standard_deviation", "global_it"))
def _gradient_hessian_jit(cfg, standard_deviation, global_it, lines, body2camera_pose,
                          intrin):
    return region_fn.calculate_gradient_and_hessian(
        cfg, lines, body2camera_pose, *intrin, standard_deviation, global_it)


@graphs.graphed(static_argnames=("cfg", "width", "height"))
def _add_colors_jit(cfg, width, height, points, n_lines, body2camera_pose, color_image,
                    memory_f, memory_b, intrin, handle_occlusions, measured, modeled,
                    region_check):
    return region_fn.add_line_pixel_colors(
        cfg, points, n_lines, body2camera_pose, color_image, memory_f, memory_b, *intrin,
        width, height, handle_occlusions, measured_occlusion=measured,
        modeled_occlusion=modeled, region_check=region_check)


def f32_intrinsics(intrinsics):
    """(fu, fv, ppu, ppv) rounded to float32, as the JAX package passes them."""
    return tuple(float(np.float32(x)) for x in (intrinsics.fu, intrinsics.fv,
                                                intrinsics.ppu, intrinsics.ppv))


# Device copies of models: model -> {(layout, device, points, offset ids): (the model's
# centers when made, the copy)}.
_MODEL_COPIES = weakref.WeakKeyDictionary()


def shared_model_arrays(cls, model, n: int, device, measured_offset_id: int,
                        modeled_offset_id: int):
    """``cls.from_models([model], n, ...)``, a batch of one in the cycle's layout
    (``pipeline.RegionModelArrays`` or ``DepthModelArrays``): made once per model,
    device, point count and offset ids and shared by every modality over the model (the
    fused serve backend batches these copies); made again after a SetUp of the model
    replaced its arrays."""
    copies = _MODEL_COPIES.setdefault(model, {})
    key = (cls, str(device), n, measured_offset_id, modeled_offset_id)
    entry = copies.get(key)
    if entry is None or entry[0] is not model.centers:
        entry = copies[key] = (model.centers, cls.from_models(
            [model], n, device=device, measured_offset_id=measured_offset_id,
            modeled_offset_id=modeled_offset_id))
    return entry[1]


def view_rows(rows: dict, n_max: int) -> dict:
    """One view's per-point rows, zero-padded to n_max points, with a leading batch
    dimension of one."""
    return {name: torch.cat([row, row.new_zeros((n_max - len(row),) + row.shape[1:])])[None]
            for name, row in rows.items()}


class RegionModality(Modality):
    def __init__(self, name: str, body_ptr, color_camera_ptr, region_model_ptr,
                 metafile_path: str | None = None, device="cuda"):
        super().__init__(name, body_ptr, metafile_path)
        self.device = resolve_device(device)
        self.color_camera_ptr = color_camera_ptr
        self.region_model_ptr = region_model_ptr

        # Parameters (defaults: region_modality.h:411-443)
        self.n_lines_max = 200
        self.use_adaptive_coverage = False
        self.reference_contour_length = 0.0
        self.min_continuous_distance = 3.0
        self.function_length = 8
        self.distribution_length = 12
        self.function_amplitude = 0.43
        self.function_slope = 0.5
        self.learning_rate = 1.3
        self.n_global_iterations = 1
        self.scales = [6, 4, 2, 1]
        self.standard_deviations = [15.0, 5.0, 3.5, 1.5]

        self.n_histogram_bins = 16
        self.learning_rate_f = 0.2
        self.learning_rate_b = 0.2
        self.unconsidered_line_length = 0.5
        self.max_considered_line_length = 20.0

        self.measured_depth_offset_radius = 0.01
        self.measured_occlusion_radius = 0.01
        self.measured_occlusion_threshold = 0.03
        self.modeled_depth_offset_radius = 0.01
        self.modeled_occlusion_radius = 0.01
        self.modeled_occlusion_threshold = 0.03
        self.n_unoccluded_iterations = 10
        self.min_n_unoccluded_lines = 0

        # Optional references
        self.depth_camera_ptr = None
        self.depth_renderer_ptr = None
        self.silhouette_renderer_ptr = None
        self.color_histograms_ptr = None  # shared histograms if set

        self.measure_occlusions = False
        self.model_occlusions = False
        self.use_region_checking = False
        self.use_shared_color_histograms = False

        # Per-modality visualization flags (region_modality.h:115-139).
        self.visualize_lines_correspondence = False
        self.visualize_points_correspondence = False
        self.visualize_points_histogram_image_correspondence = False
        self.visualize_points_optimization = False
        self.visualize_points_histogram_image_optimization = False
        self.visualize_points_result = False
        self.visualize_points_histogram_image_result = False
        self.visualization_min_depth = 0.0
        self.visualization_max_depth = 1.0

        # Internal state
        self._cfg: RegionConfig | None = None
        self._lookup_f = None
        self._lookup_b = None
        self.data_lines = None
        self.first_iteration = 0
        self._view_index = -1
        self._points: ViewPoints | None = None
        self._n_lines = 0
        self._scale = 1
        self._standard_deviation = 1.5

    # -- configuration -----------------------------------------------------------------

    def MeasureOcclusions(self, depth_camera_ptr) -> None:  # noqa: N802
        self.depth_camera_ptr = depth_camera_ptr
        self.measure_occlusions = True
        self.set_up = False

    def ModelOcclusions(self, depth_renderer_ptr) -> None:  # noqa: N802
        self.depth_renderer_ptr = depth_renderer_ptr
        self.model_occlusions = True
        self.set_up = False

    def UseRegionChecking(self, silhouette_renderer_ptr) -> None:  # noqa: N802
        self.silhouette_renderer_ptr = silhouette_renderer_ptr
        self.use_region_checking = True
        self.set_up = False

    def UseSharedColorHistograms(self, color_histograms_ptr) -> None:  # noqa: N802
        self.color_histograms_ptr = color_histograms_ptr
        self.use_shared_color_histograms = True
        self.set_up = False

    def DoNotUseSharedColorHistograms(self) -> None:  # noqa: N802
        self.color_histograms_ptr = None
        self.use_shared_color_histograms = False
        self.set_up = False

    def _load_metadata(self) -> bool:
        fs = yaml_io.open_yaml_file_storage(self.metafile_path)

        def g(key, cur):
            return yaml_io.read_optional(fs, key, cur)

        self.n_lines_max = int(g("n_lines", self.n_lines_max))
        self.use_adaptive_coverage = bool(g("use_adaptive_coverage",
                                            self.use_adaptive_coverage))
        self.reference_contour_length = float(g("reference_contour_length",
                                                self.reference_contour_length))
        self.min_continuous_distance = float(g("min_continuous_distance",
                                               self.min_continuous_distance))
        self.function_length = int(g("function_length", self.function_length))
        self.distribution_length = int(g("distribution_length", self.distribution_length))
        self.function_amplitude = float(g("function_amplitude", self.function_amplitude))
        self.function_slope = float(g("function_slope", self.function_slope))
        self.learning_rate = float(g("learning_rate", self.learning_rate))
        self.n_global_iterations = int(g("n_global_iterations", self.n_global_iterations))
        scales = g("scales", None)
        if scales is not None:
            self.scales = [int(s) for s in scales]
        stddevs = g("standard_deviations", None)
        if stddevs is not None:
            self.standard_deviations = [float(s) for s in stddevs]
        self.n_histogram_bins = int(g("n_histogram_bins", self.n_histogram_bins))
        self.learning_rate_f = float(g("learning_rate_f", self.learning_rate_f))
        self.learning_rate_b = float(g("learning_rate_b", self.learning_rate_b))
        self.unconsidered_line_length = float(g("unconsidered_line_length",
                                                self.unconsidered_line_length))
        self.max_considered_line_length = float(g("max_considered_line_length",
                                                  self.max_considered_line_length))
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
        for flag in _VISUALIZATION_FLAGS:
            setattr(self, flag, bool(g(flag, getattr(self, flag))))
        self.visualization_min_depth = float(g("visualization_min_depth",
                                               self.visualization_min_depth))
        self.visualization_max_depth = float(g("visualization_max_depth",
                                               self.visualization_max_depth))
        self.save_directory = str(g("save_directory", self.save_directory))
        self.min_n_unoccluded_lines = int(g("min_n_unoccluded_lines",
                                            self.min_n_unoccluded_lines))
        return True

    # -- setup -------------------------------------------------------------------------

    def SetUp(self) -> bool:  # noqa: N802
        self.set_up = False
        if self.metafile_path:
            if not self._load_metadata():
                return False
        required = [("body", self.body_ptr), ("color camera", self.color_camera_ptr),
                    ("region model", self.region_model_ptr)]
        if self.measure_occlusions:
            required.append(("depth camera", self.depth_camera_ptr))
        if self.model_occlusions:
            required.append(("depth renderer", self.depth_renderer_ptr))
        if self.use_region_checking:
            required.append(("silhouette renderer", self.silhouette_renderer_ptr))
        if self.use_shared_color_histograms:
            required.append(("color histograms", self.color_histograms_ptr))
        for label, ptr in required:
            if ptr is None or not ptr.set_up:
                print(f"{label} for region modality {self.name} was not set up")
                return False

        if not self.use_shared_color_histograms:
            from m3t_tpu_torch.color_histograms import ColorHistograms

            self.color_histograms_ptr = ColorHistograms(
                f"{self.name}_histograms", self.n_histogram_bins, self.learning_rate_f,
                self.learning_rate_b, device=self.device)
            if not self.color_histograms_ptr.SetUp():
                return False
        else:
            self.n_histogram_bins = self.color_histograms_ptr.n_bins

        # Depth-offset ids (PrecalculateModelVariables, cpp:965-989)
        m = self.region_model_ptr
        stride = m.stride_depth_offset
        for radius, label in ((self.measured_depth_offset_radius, "measured"),
                              (self.modeled_depth_offset_radius, "modeled")):
            if radius > m.max_radius_depth_offset:
                print(f"{label} depth offset radius too large: {radius} > "
                      f"{m.max_radius_depth_offset}")
                return False
        self.measured_depth_offset_id = int(self.measured_depth_offset_radius / stride + 0.5)
        self.modeled_depth_offset_id = int(self.modeled_depth_offset_radius / stride + 0.5)

        self._cfg = RegionConfig(
            n_lines_max=self.n_lines_max,
            function_length=self.function_length,
            distribution_length=self.distribution_length,
            function_amplitude=self.function_amplitude,
            function_slope=self.function_slope,
            learning_rate=self.learning_rate,
            n_global_iterations=self.n_global_iterations,
            min_continuous_distance=self.min_continuous_distance,
            n_histogram_bins=self.n_histogram_bins,
            unconsidered_line_length=self.unconsidered_line_length,
            max_considered_line_length=self.max_considered_line_length,
            measured_occlusion_radius=self.measured_occlusion_radius,
            measured_occlusion_threshold=self.measured_occlusion_threshold,
            modeled_occlusion_radius=self.modeled_occlusion_radius,
            modeled_occlusion_threshold=self.modeled_occlusion_threshold,
            min_n_unoccluded_lines=self.min_n_unoccluded_lines,
        )
        self._lookup_f, self._lookup_b = (torch.as_tensor(a, device=self.device)
                                          for a in self._cfg.function_lookups())

        # The whole model on the device for the view gathers, one copy per model.
        self._model_arrays = shared_model_arrays(
            pipeline.RegionModelArrays, m, self.n_lines_max, self.device,
            self.measured_depth_offset_id, self.modeled_depth_offset_id)
        self.set_up = True
        return True

    # -- per-frame helpers -------------------------------------------------------------

    def _body2camera_pose(self) -> np.ndarray:
        return self.color_camera_ptr.world2camera_pose @ self.body_ptr.body2world_pose

    def _tensor(self, a):
        """A host array, or a tensor on any device (a renderer's image), on the
        modality's device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _fetch_view(self):
        """GetClosestView + adaptive line count (cpp:411-430); returns the
        body2camera pose as a (1, 4, 4) tensor."""
        pose = self._body2camera_pose()
        m = self.region_model_ptr
        idx = m.GetClosestViewIndex(pose)
        if self.use_adaptive_coverage:
            contour_length = float(m.contour_lengths[idx])
            if self.reference_contour_length > 0.0:
                ratio = min(1.0, contour_length / self.reference_contour_length)
            else:
                ratio = (contour_length / m.max_contour_length
                         if m.max_contour_length > 0 else 1.0)
            n_lines = int(self.n_lines_max * ratio)
        else:
            n_lines = self.n_lines_max
        n_points_available = m.centers.shape[1]
        if n_lines > n_points_available:
            print(f"Number of model points too small: {n_points_available} < {n_lines}")
            n_lines = n_points_available
        self._view_index = idx
        a = self._model_arrays  # (1, V, 3, L) points, (1, V, L) values
        self._points = ViewPoints(**view_rows(dict(
            center_f_body=a.centers[0, idx].T, normal_f_body=a.normals[0, idx].T,
            foreground_distance=a.foreground_distances[0, idx],
            background_distance=a.background_distances[0, idx],
            measured_depth_offset=a.measured_depth_offsets[0, idx],
            modeled_depth_offset=a.modeled_depth_offsets[0, idx]), self.n_lines_max))
        self._n_lines = n_lines
        return self._tensor(pose)[None]

    def _occlusion_inputs(self):
        """The measured, modeled and region-check inputs that are switched on (else
        None), each a batch of one."""
        measured = modeled = region_check = None
        if self.measure_occlusions:
            dc = self.depth_camera_ptr
            fu, fv, ppu, ppv = f32_intrinsics(dc.intrinsics)
            measured = MeasuredOcclusionInputs(
                depth_image=self._tensor(dc.image)[None],
                body2depth_camera_pose=self._tensor(
                    dc.world2camera_pose @ self.body_ptr.body2world_pose)[None],
                fu=fu, fv=fv, ppu=ppu, ppv=ppv,
                depth_scale=float(np.float32(dc.depth_scale)))
        if self.model_occlusions:
            r = self.depth_renderer_ptr
            modeled = ModeledOcclusionInputs(
                focused_depth=self._tensor(r.focused_depth_image())[None],
                corner_u=self._tensor([r.corner_u]).float(),
                corner_v=self._tensor([r.corner_v]).float(),
                scale=self._tensor([r.scale]).float(),
                body_visible=self._tensor([r.IsBodyVisible(self.body_ptr.name)]))
        if self.use_region_checking:
            r = self.silhouette_renderer_ptr
            region_check = RegionCheckInputs(
                silhouette=self._tensor(r.focused_silhouette_image())[None].to(torch.int32),
                corner_u=self._tensor([r.corner_u]).float(),
                corner_v=self._tensor([r.corner_v]).float(),
                scale=self._tensor([r.scale]).float(),
                region_id=self._tensor([self.body_ptr.region_id]).to(torch.int32),
                body_visible=self._tensor([r.IsBodyVisible(self.body_ptr.name)]))
        return measured, modeled, region_check

    def _per_body_inputs(self, handle_occlusions: bool):
        """The line count and handle_occlusions as (1,) tensors on the device."""
        return (torch.tensor([self._n_lines], dtype=torch.int32, device=self.device),
                torch.tensor([handle_occlusions], device=self.device))

    def _iteration_scale(self, corr_iteration: int):
        """LastValidValue over scales/standard_deviations (cpp:1011-1023)."""
        scale = self.scales[min(corr_iteration, len(self.scales) - 1)]
        std = self.standard_deviations[
            min(corr_iteration, len(self.standard_deviations) - 1)]
        return int(scale), float(std)

    # -- protocol ----------------------------------------------------------------------

    def StartModality(self, iteration: int, corr_iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up region modality {self.name} first")
            return False
        self.first_iteration = iteration
        if not self.use_shared_color_histograms:
            self.color_histograms_ptr.ClearMemory()
        self._add_line_pixel_colors(self.n_unoccluded_iterations == 0)
        if not self.use_shared_color_histograms:
            self.color_histograms_ptr.InitializeHistograms()
        return True

    def _add_line_pixel_colors(self, handle_occlusions: bool) -> None:
        pose = self._fetch_view()
        intr = self.color_camera_ptr.intrinsics
        measured, modeled, region_check = self._occlusion_inputs()
        n_lines, handle = self._per_body_inputs(handle_occlusions)
        hist = self.color_histograms_ptr
        memory_f, memory_b = _add_colors_jit(
            self._cfg, intr.width, intr.height, self._points, n_lines, pose,
            self._tensor(self.color_camera_ptr.image)[None], hist.memory_f[None],
            hist.memory_b[None], f32_intrinsics(intr), handle, measured, modeled,
            region_check)
        hist.memory_f, hist.memory_b = memory_f[0], memory_b[0]

    def _handle_occlusions(self, iteration: int) -> bool:
        return iteration - self.first_iteration >= self.n_unoccluded_iterations

    def CalculateCorrespondences(self, iteration: int, corr_iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up region modality {self.name} first")
            return False
        self._scale, self._standard_deviation = self._iteration_scale(corr_iteration)
        pose = self._fetch_view()
        intr = self.color_camera_ptr.intrinsics
        measured, modeled, region_check = self._occlusion_inputs()
        n_lines, handle = self._per_body_inputs(self._handle_occlusions(iteration))
        hist = self.color_histograms_ptr
        self.data_lines = _correspondences_jit(
            self._cfg, self._scale, intr.width, intr.height, self._points, n_lines, pose,
            self._tensor(self.color_camera_ptr.image)[None], hist.histogram_f[None],
            hist.histogram_b[None], f32_intrinsics(intr), handle, measured, modeled,
            region_check, self._lookup_f, self._lookup_b)
        return True

    def CalculateGradientAndHessian(self, iteration: int, corr_iteration: int,
                                    opt_iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up region modality {self.name} first")
            return False
        gradient, hessian = _gradient_hessian_jit(
            self._cfg, self._standard_deviation, opt_iteration < self.n_global_iterations,
            self.data_lines, self._tensor(self._body2camera_pose())[None],
            f32_intrinsics(self.color_camera_ptr.intrinsics))
        self.gradient, self.hessian = gradient[0], hessian[0]
        return True

    def CalculateResults(self, iteration: int) -> bool:  # noqa: N802
        if not self.set_up:
            print(f"Set up region modality {self.name} first")
            return False
        if not self.use_shared_color_histograms:
            self.color_histograms_ptr.ClearMemory()
        self._add_line_pixel_colors(self._handle_occlusions(iteration))
        if not self.use_shared_color_histograms:
            self.color_histograms_ptr.UpdateHistograms()
        return True

    # -- visualization (region_modality.cpp:467-481, 560-571, 585-596) -----------------

    def _valid_centers_f_camera(self) -> np.ndarray:
        pose = self._body2camera_pose()
        centers = to_numpy(self.data_lines.center_f_body[0])
        valid = to_numpy(self.data_lines.valid[0])
        return centers[valid] @ pose[:3, :3].T + pose[:3, 3]

    def _show(self, title: str, save_idx: int, image) -> None:
        visualization.show_and_save_image(
            f"{self.name}_{title}", save_idx, image, self.display_visualization,
            self.save_visualizations, self.save_directory, self.save_image_type)

    def _probability_image(self) -> np.ndarray:
        hist = self.color_histograms_ptr
        return visualization.probability_image(
            np.asarray(self.color_camera_ptr.image), hist.histogram_f, hist.histogram_b,
            self.n_histogram_bins)

    def _points_image(self, base: np.ndarray) -> np.ndarray:
        intr = self.color_camera_ptr.intrinsics
        image = base.copy()
        visualization.draw_points(image, self._valid_centers_f_camera(),
                                  intr.fu, intr.fv, intr.ppu, intr.ppv)
        return image

    def _visualizing(self) -> bool:
        return ((self.display_visualization or self.save_visualizations)
                and self.data_lines is not None)

    def VisualizeCorrespondences(self, save_idx: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        if not self._visualizing():
            return True
        if self.visualize_lines_correspondence:
            image = self._probability_image()
            dl = self.data_lines
            visualization.draw_correspondence_lines(
                image, to_numpy(dl.center_u[0]), to_numpy(dl.center_v[0]),
                to_numpy(dl.normal_u[0]), to_numpy(dl.normal_v[0]),
                to_numpy(dl.distribution[0]), to_numpy(dl.valid[0]), self._scale,
                self.distribution_length)
            self._show("lines_correspondence", save_idx, image)
        if self.visualize_points_correspondence:
            self._show("color_image_correspondence", save_idx,
                       self._points_image(np.asarray(self.color_camera_ptr.image)))
        if self.visualize_points_histogram_image_correspondence:
            self._show("histogram_image_correspondence", save_idx,
                       self._points_image(self._probability_image()))
        return True

    def VisualizeOptimization(self, save_idx: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        if self.visualize_gradient_optimization:
            print(f"gradient {self.name}:\n{to_numpy(self.gradient)}")
        if self.visualize_hessian_optimization:
            print(f"hessian {self.name}:\n{to_numpy(self.hessian)}")
        if not self._visualizing():
            return True
        if self.visualize_points_optimization:
            self._show("color_image_optimization", save_idx,
                       self._points_image(np.asarray(self.color_camera_ptr.image)))
        if self.visualize_points_histogram_image_optimization:
            self._show("histogram_image_optimization", save_idx,
                       self._points_image(self._probability_image()))
        return True

    def VisualizeResults(self, save_idx: int) -> bool:  # noqa: N802
        if not self.set_up:
            return False
        if self.visualize_pose_result:
            print(f"body2world_pose {self.name}:\n{self.body_ptr.body2world_pose}")
        if not self._visualizing():
            return True
        if self.visualize_points_result:
            self._show("color_image_result", save_idx,
                       self._points_image(np.asarray(self.color_camera_ptr.image)))
        if self.visualize_points_histogram_image_result:
            self._show("histogram_image_result", save_idx,
                       self._points_image(self._probability_image()))
        return True

    # -- referenced objects (region_modality.cpp:618-646) ------------------------------

    def camera_ptrs(self) -> list:
        out = [self.color_camera_ptr]
        if self.measure_occlusions and self.depth_camera_ptr:
            out.append(self.depth_camera_ptr)
        return out

    def model_ptr(self):
        return self.region_model_ptr

    def _renderers(self) -> list:
        out = []
        if self.model_occlusions and self.depth_renderer_ptr:
            out.append(self.depth_renderer_ptr)
        if self.use_region_checking and self.silhouette_renderer_ptr:
            out.append(self.silhouette_renderer_ptr)
        return out

    def start_modality_renderer_ptrs(self) -> list:
        return self._renderers()

    def correspondence_renderer_ptrs(self) -> list:
        return self._renderers()

    def results_renderer_ptrs(self) -> list:
        return self._renderers()

    def color_histograms_ptr_shared(self):
        if self.use_shared_color_histograms and self.color_histograms_ptr:
            return self.color_histograms_ptr
        return None
