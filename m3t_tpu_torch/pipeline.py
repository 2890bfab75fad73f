"""Fused batched tracking cycles on PyTorch/CUDA (port of m3t_tpu/pipeline.py: the
region cycle and the region+depth (ICG) cycle, with measured occlusions, with the
focused scene's modeled occlusions, region checking and silhouette check, and with
texture terms; the articulated cycle over kinematic structures; and the multi-camera
cycles of both over a mesh of processes).

One :func:`tracking_cycle` (or :func:`tracking_cycle_rgbd`) call runs every
correspondence x update iteration plus the histogram adaptation for a batch of
independent bodies.  :func:`tracking_cycle_kinematic` runs the same loop over the links
of S structures, its Newton step the batched KKT solve of ops/kinematics.py.  Where the
JAX package jits these three, the port graphs them (graphs.graphed, ``pcfg`` static):
on the card each replays one CUDA graph per static key, and on the CPU it runs eagerly.
The cycles of :func:`make_sharded_cycle` and :func:`make_sharded_kinematic_cycle` run
the loop over every (body, camera), their step summing each body's camera terms first;
they are graphed too, keyed on what they were built from (``pcfg``, the mesh, the
intrinsics and the ``with_*`` flags, by value).  Their camera sum's torch.distributed
all_reduce runs between captured segments (graphs.collective): a mesh with a camera
group of n > 1 ranks captures one segment more than the cycle has Newton steps, and the
replay runs each all_reduce between two segments; one process is one segment.
Hot-path structure:

  1. per body: crop the image once around the projected body origin and convert it to
     flat histogram-bin indices;
  2. per correspondence iteration: closest view, line geometry, then the
     ``sample_lines`` kernel fetches per-line probability samples, reduced to
     distributions and moments.  RGB-D: the ``sample_windows`` kernel fetches the
     strided correspondence-search windows (and the measured-occlusion windows of
     either modality) from the depth frame, confined to a crop around the projected
     body origin whose corner is computed once per cycle.  With a
     scene (``scene_geom``), the focused scene is evaluated at the current pose
     first: the ``query_eval`` kernel evaluates its triangles at the pixels that the
     modeled-occlusion, region and silhouette checks sample (or, with
     ``occlusion_queries=False``, the scene is rasterized into focused crops);
  3. per update iteration: gradient/Hessian (region, depth and texture terms) and a
     batched Tikhonov 6x6 LDLT Newton step, the ``newton_step`` kernel (ops/newton.py;
     articulated: the KKT step of every structure, the link poses recomputed from the
     joint state before each);
  4. histogram adaptation: ``sample_lines`` in bins mode walks the fg/bg color lines and
     the ``bin_counts`` kernel counts the bins.

Reference mapping: one call == Tracker::ExecuteTrackingStep + CalculateResults
(tracker.cpp:344-364) for every tracked body at once.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch
import torch.distributed

from m3t_tpu_torch import graphs
from m3t_tpu_torch.common import resolve_device
from m3t_tpu_torch.ops import depth_fast, depth_fn, occlusion, texture_fn
from m3t_tpu_torch.ops import histogram as hist_ops
from m3t_tpu_torch.ops import kinematics as kin_ops
from m3t_tpu_torch.ops import newton
from m3t_tpu_torch.ops import region_fast
from m3t_tpu_torch.ops.depth_fn import DepthConfig, DepthViewPoints
from m3t_tpu_torch.ops.region_fast import ViewPointsCL
from m3t_tpu_torch.ops.texture_fn import TexturePoints
from m3t_tpu_torch.ops.region_fn import (MeasuredOcclusionInputs, ModeledOcclusionInputs,
                                          ModeledOcclusionQueryInputs, RegionCheckInputs,
                                          RegionCheckQueryInputs, RegionConfig)
from m3t_tpu_torch.utils import timing


def _as_tensor(a, device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)


def _load_npz_models(paths: str | Sequence[str]) -> list[dict]:
    """The arrays of model cache files (the npz that m3t_tpu's models write)."""
    if isinstance(paths, str):
        paths = [paths]
    models = []
    for path in paths:
        with np.load(path, allow_pickle=False) as data:
            models.append({k: data[k] for k in data.files if k != "checksum"})
    return models


_REGION_FIELDS = ("orientations", "centers", "normals", "foreground_distances",
                  "background_distances", "depth_offsets", "contour_lengths")
_DEPTH_FIELDS = ("orientations", "centers", "normals", "depth_offsets")


def _model_arrays(models, fields) -> list[dict]:
    """The arrays of set-up model objects, as _load_npz_models gives a cache file's."""
    if any(not m.set_up for m in models):
        raise ValueError("from_models needs set-up models (call SetUp() first)")
    return [{k: getattr(m, k) for k in fields} for m in models]


def _stack_views(models: list[dict], fn, device) -> torch.Tensor:
    """Stack fn(model) over bodies as float32, views zero-padded to the largest V."""
    v_max = max(m["orientations"].shape[0] for m in models)
    rows = []
    for m in models:
        a = fn(m)
        out = np.zeros((v_max,) + a.shape[1:], a.dtype)
        out[:a.shape[0]] = a
        rows.append(out)
    return _as_tensor(np.stack(rows), device, torch.float32)


class RegionModelArrays(NamedTuple):
    """Stacked sparse-viewpoint model for a batch of bodies (device-resident).

    Point data is channel-major ((V, 3, L)), as in the JAX package.
    """

    orientations: torch.Tensor  # (B, V, 3)
    centers: torch.Tensor  # (B, V, 3, L)
    normals: torch.Tensor  # (B, V, 3, L)
    foreground_distances: torch.Tensor  # (B, V, L)
    background_distances: torch.Tensor  # (B, V, L)
    measured_depth_offsets: torch.Tensor  # (B, V, L)
    modeled_depth_offsets: torch.Tensor  # (B, V, L)
    contour_lengths: torch.Tensor  # (B, V) — per-view silhouette contour length
    max_contour_length: torch.Tensor  # (B,)

    @staticmethod
    def from_numpy(arrays, device="cuda") -> "RegionModelArrays":
        """From a mapping of field name -> numpy array (the JAX package's
        RegionModelArrays as numpy)."""
        dev = resolve_device(device)
        return RegionModelArrays(*(_as_tensor(arrays[name], dev, torch.float32)
                                   for name in RegionModelArrays._fields))

    @staticmethod
    def from_npz(paths: str | Sequence[str], n_lines: int,
                 device="cuda") -> "RegionModelArrays":
        """Stack region-model cache files (the npz that ``region_model.RegionModel`` of
        either package writes) into a batch, one body per file: the first n_lines points
        of every view, (V, L, 3) -> (V, 3, L), views zero-padded to the largest V."""
        return RegionModelArrays._stack(_load_npz_models(paths), n_lines, device)

    @staticmethod
    def from_models(models, n_lines: int, device="cuda", measured_offset_id: int = 5,
                    modeled_offset_id: int = 5) -> "RegionModelArrays":
        """Stack set-up :class:`m3t_tpu_torch.region_model.RegionModel` objects into a
        batch, as from_npz stacks their cache files (m3t_tpu/pipeline.py:71), with the
        depth offsets of the given offset ids."""
        return RegionModelArrays._stack(_model_arrays(models, _REGION_FIELDS), n_lines,
                                        device, measured_offset_id, modeled_offset_id)

    @staticmethod
    def _stack(models: list[dict], n_lines: int, device, measured_offset_id: int = 5,
               modeled_offset_id: int = 5) -> "RegionModelArrays":
        dev = resolve_device(device)

        def stack(fn):
            return _stack_views(models, fn, dev)

        def cl(a):  # (V, L, 3) -> (V, 3, L)
            return np.swapaxes(a[:, :n_lines], -1, -2)

        # Offset 5 by default, the region modality's default offset ids
        # (m3t_tpu/region_modality.py:283-286).
        measured = stack(lambda m: m["depth_offsets"][:, :n_lines, measured_offset_id])
        modeled = (measured if modeled_offset_id == measured_offset_id else
                   stack(lambda m: m["depth_offsets"][:, :n_lines, modeled_offset_id]))
        return RegionModelArrays(
            orientations=stack(lambda m: m["orientations"]),
            centers=stack(lambda m: cl(m["centers"])),
            normals=stack(lambda m: cl(m["normals"])),
            foreground_distances=stack(lambda m: m["foreground_distances"][:, :n_lines]),
            background_distances=stack(lambda m: m["background_distances"][:, :n_lines]),
            measured_depth_offsets=measured,
            modeled_depth_offsets=modeled,
            contour_lengths=stack(lambda m: np.asarray(m["contour_lengths"], np.float32)),
            max_contour_length=_as_tensor(
                np.array([np.max(m["contour_lengths"]) for m in models], np.float32),
                dev),
        )

    def expand(self, n_bodies: int) -> "RegionModelArrays":
        """The single model of a batch of one, broadcast (as a view) to n_bodies."""
        return RegionModelArrays(*(a.expand((n_bodies,) + a.shape[1:]) for a in self))


class DepthModelArrays(NamedTuple):
    """Stacked depth sparse-viewpoint model for a batch of bodies (device-resident)."""

    orientations: torch.Tensor  # (B, V, 3)
    centers: torch.Tensor  # (B, V, P, 3)
    normals: torch.Tensor  # (B, V, P, 3)
    measured_depth_offsets: torch.Tensor  # (B, V, P)
    modeled_depth_offsets: torch.Tensor  # (B, V, P)

    @staticmethod
    def from_numpy(arrays, device="cuda") -> "DepthModelArrays":
        """From a mapping of field name -> numpy array (the JAX package's
        DepthModelArrays as numpy)."""
        dev = resolve_device(device)
        return DepthModelArrays(*(_as_tensor(arrays[name], dev, torch.float32)
                                  for name in DepthModelArrays._fields))

    @staticmethod
    def from_npz(paths: str | Sequence[str], n_points: int,
                 device="cuda") -> "DepthModelArrays":
        """Stack depth-model cache files (the npz that ``depth_model.DepthModel`` of
        either package writes) into a batch, one body per file: the first n_points
        points of every view, views zero-padded to the largest V."""
        return DepthModelArrays._stack(_load_npz_models(paths), n_points, device)

    @staticmethod
    def from_models(models, n_points: int, device="cuda", measured_offset_id: int = 5,
                    modeled_offset_id: int = 5) -> "DepthModelArrays":
        """Stack set-up :class:`m3t_tpu_torch.depth_model.DepthModel` objects into a
        batch, as from_npz stacks their cache files (m3t_tpu/pipeline.py:115), with the
        depth offsets of the given offset ids."""
        return DepthModelArrays._stack(_model_arrays(models, _DEPTH_FIELDS), n_points,
                                       device, measured_offset_id, modeled_offset_id)

    @staticmethod
    def _stack(models: list[dict], n_points: int, device, measured_offset_id: int = 5,
               modeled_offset_id: int = 5) -> "DepthModelArrays":
        dev = resolve_device(device)

        def stack(fn):
            return _stack_views(models, fn, dev)

        # Offset 5 by default, the depth modality's default offset ids
        # (m3t_tpu/depth_modality.py:163-169).
        measured = stack(lambda m: m["depth_offsets"][:, :n_points, measured_offset_id])
        modeled = (measured if modeled_offset_id == measured_offset_id else
                   stack(lambda m: m["depth_offsets"][:, :n_points, modeled_offset_id]))
        return DepthModelArrays(
            orientations=stack(lambda m: m["orientations"]),
            centers=stack(lambda m: m["centers"][:, :n_points]),
            normals=stack(lambda m: m["normals"][:, :n_points]),
            measured_depth_offsets=measured,
            modeled_depth_offsets=modeled,
        )

    def expand(self, n_bodies: int) -> "DepthModelArrays":
        """The single model of a batch of one, broadcast (as a view) to n_bodies."""
        return DepthModelArrays(*(a.expand((n_bodies,) + a.shape[1:]) for a in self))


class TrackingState(NamedTuple):
    """Per-body tracking state carried frame to frame."""

    body2camera_pose: torch.Tensor  # (B, 4, 4)
    histogram_f: torch.Tensor  # (B, n_bins^3)
    histogram_b: torch.Tensor  # (B, n_bins^3)

    @staticmethod
    def from_numpy(body2camera_pose, histogram_f, histogram_b,
                   device="cuda") -> "TrackingState":
        dev = resolve_device(device)
        return TrackingState(*(_as_tensor(a, dev, torch.float32)
                               for a in (body2camera_pose, histogram_f, histogram_b)))


class PipelineConfig(NamedTuple):
    """PipelineConfig of m3t_tpu/pipeline.py: the region cycle, depth fusion, texture
    terms, measured occlusions and the focused scene's checks."""

    cfg: RegionConfig = RegionConfig()
    scales: tuple = (6, 4, 2, 1)
    standard_deviations: tuple = (15.0, 5.0, 3.5, 1.5)
    n_corr_iterations: int = 5
    n_update_iterations: int = 2
    tikhonov_rotation: float = 1000.0
    tikhonov_translation: float = 30000.0
    learning_rate_f: float = 0.2
    learning_rate_b: float = 0.2
    crop_size: int = 256  # focused-crop side
    # ICG-style depth fusion (used by tracking_cycle_rgbd).
    use_depth: bool = False
    depth_cfg: DepthConfig = DepthConfig()
    considered_distances: tuple = (0.05, 0.02, 0.01)
    depth_standard_deviations: tuple = (0.05, 0.03, 0.02)
    # ICG+ texture fusion: Tukey-weighted reprojection terms of host feature matches
    # (the cycles' texture_points input).
    use_texture: bool = False
    texture_standard_deviations: tuple = (15.0, 5.0)
    tukey_norm_constant: float = 20.0
    # Occlusion handling and region checking.  The measured occlusions read the depth
    # images (tracking_cycle_rgbd only); the modeled occlusions, region checking and the
    # depth silhouette check read the focused scene (a SceneGeometry input), evaluated
    # at the current pose every correspondence iteration (tracker.cpp:448-451).
    region_model_occlusions: bool = False
    region_measure_occlusions: bool = False
    region_checking: bool = False
    depth_model_occlusions: bool = False
    depth_measure_occlusions: bool = False
    depth_silhouette_check: bool = False
    focused_image_size: int = 200
    z_min: float = 0.02
    z_max: float = 10.0
    occlusion_raster_chunk: int = 64
    # Adaptive coverage (region_modality.cpp:417-429): scale the traced line
    # count per body by the closest view's contour length, relative to
    # reference_contour_length (if > 0) or the model's max contour length.
    use_adaptive_coverage: bool = False
    reference_contour_length: float = 0.0
    # Point-query scene evaluation (default): the checks read about 50 focused pixels
    # per line or point, so the scene's triangles are evaluated at exactly those pixels
    # (ops/occlusion.py SceneCoeffs, the query_eval kernel).  False renders full
    # focused crops (ops/occlusion.focused_render) with the same results.
    occlusion_queries: bool = True

    @property
    def needs_scene_render(self) -> bool:
        return (self.region_model_occlusions or self.region_checking
                or self.depth_model_occlusions or self.depth_silhouette_check)

    def iteration_scale(self, corr_iteration: int):
        scale = self.scales[min(corr_iteration, len(self.scales) - 1)]
        std = self.standard_deviations[
            min(corr_iteration, len(self.standard_deviations) - 1)]
        return int(scale), float(std)

    def iteration_depth(self, corr_iteration: int):
        cd = self.considered_distances[
            min(corr_iteration, len(self.considered_distances) - 1)]
        std = self.depth_standard_deviations[
            min(corr_iteration, len(self.depth_standard_deviations) - 1)]
        return float(cd), float(std)

    def iteration_texture_std(self, corr_iteration: int) -> float:
        stds = self.texture_standard_deviations
        return float(stds[min(corr_iteration, len(stds) - 1)])

    @property
    def lp(self) -> int:
        return region_fast.round_up(max(self.cfg.n_lines_max, 1), 128)


def _view_index(orientations, pose):
    """GetClosestView index per body: argmax dot (region_model.cpp:105-127)."""
    t = pose[:, :3, 3]
    norm = torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True))
    unit = t / torch.where(norm > 0, norm, torch.ones_like(norm))
    orientation = pose[:, :3, :3].transpose(1, 2) @ unit[:, :, None]   # (B, 3, 1)
    return torch.argmax((orientations @ orientation)[:, :, 0], dim=-1)


def _closest_view(orientations, pose, body):
    """(model row, closest view) of every batch entry: body (B,) int64 names the model
    row, None the entry's own row."""
    if body is None:
        return torch.arange(pose.shape[0], device=pose.device), _view_index(orientations, pose)
    return body, _view_index(orientations[body], pose)


def _adaptive_n_lines(pcfg: PipelineConfig, model: RegionModelArrays, poses, body=None):
    """Per-body traced line count, scaled by the closest view's contour length when
    adaptive coverage is on (region_modality.cpp:417-429: int truncation of
    n_lines_max * ratio, clamped to the available model points).  body: the model row
    of every batch entry (see _select_view_cl).

    Returns a Python int when adaptive coverage is off, else a (B,) int32 tensor."""
    cfg = pcfg.cfg
    if not pcfg.use_adaptive_coverage:
        return int(cfg.n_lines_max)
    body, idx = _closest_view(model.orientations, poses, body)
    contour_length = model.contour_lengths[body, idx]
    if pcfg.reference_contour_length > 0.0:
        ratio = torch.clamp(depth_fn.div_const(contour_length, pcfg.reference_contour_length),
                            max=1.0)
    else:
        mcl = model.max_contour_length[body]
        ratio = torch.where(mcl > 0,
                            contour_length / torch.where(mcl > 0, mcl, torch.ones_like(mcl)),
                            torch.ones_like(mcl))
    n = (float(cfg.n_lines_max) * ratio).to(torch.int32)
    return torch.clamp(n, max=model.centers.shape[-1])


def _select_view_cl(model: RegionModelArrays, pose, body=None) -> ViewPointsCL:
    """GetClosestView per body: index + gather.  body (B,) int64 names the model row of
    every batch entry (the multi-camera cycles read one model row for each of a body's
    cameras, without copying the model per camera); None: entry b reads row b."""
    body, idx = _closest_view(model.orientations, pose, body)
    return ViewPointsCL(
        center_f_body=model.centers[body, idx],
        normal_f_body=model.normals[body, idx],
        foreground_distance=model.foreground_distances[body, idx],
        background_distance=model.background_distances[body, idx],
        measured_depth_offset=model.measured_depth_offsets[body, idx],
        modeled_depth_offset=model.modeled_depth_offsets[body, idx],
    )


def _select_depth_view(model: DepthModelArrays, pose, body=None) -> DepthViewPoints:
    """GetClosestView of the depth model per body: index + gather (body as in
    _select_view_cl)."""
    body, idx = _closest_view(model.orientations, pose, body)
    return DepthViewPoints(
        center_f_body=model.centers[body, idx],
        normal_f_body=model.normals[body, idx],
        measured_depth_offset=model.measured_depth_offsets[body, idx],
        modeled_depth_offset=model.modeled_depth_offsets[body, idx],
    )


def _planar_u8(images):
    """Accept (B, H, W, 3) or planar (B, 3, H, W) uint8 images; return planar."""
    if images.shape[-1] == 3:
        return images.permute(0, 3, 1, 2)
    return images


def _pad_image(images_planar, crop_size: int):
    """Zero-pad so both spatial dims are >= crop_size (small test images)."""
    _, _, h, w = images_planar.shape
    ph = max(crop_size - h, 0)
    pw = max(crop_size - w, 0)
    if ph or pw:
        images_planar = torch.nn.functional.pad(images_planar, (0, pw, 0, ph))
    return images_planar


def _intrinsics(intr):
    return tuple(float(x) for x in intr)


def _prepare_crops(pcfg: PipelineConfig, intr, images, poses):
    """Prologue: per-body focused bin crops around the projected body origin."""
    fu, fv, ppu, ppv = _intrinsics(intr)
    planar = _pad_image(_planar_u8(images), pcfg.crop_size)
    t = poses[:, :3, 3]
    z = torch.where(t[:, 2] > 0, t[:, 2], torch.ones_like(t[:, 2]))
    cu = t[:, 0] * fu / z + ppu
    cv = t[:, 1] * fv / z + ppv
    corner_u, corner_v = region_fast.crop_corners(
        cu, cv, pcfg.crop_size, planar.shape[3], planar.shape[2])
    bin_crop = region_fast.binify_crops(
        planar, corner_u, corner_v, pcfg.crop_size, pcfg.cfg.n_histogram_bins)
    return bin_crop, corner_u, corner_v


def _solve_and_update(pcfg: PipelineConfig, gradient, hessian, pose, group=None):
    """Batched Tikhonov-regularized Newton step (optimizer.cpp:144-167, single link).

    ``group`` (B,) int optionally ties slots to a shared pose: slot terms are summed per
    group and gathered back before the solve, so every slot of a group takes the
    identical Newton step (several region models summing into one Link,
    ycb_evaluator.cpp:427-453, link.cpp:184-193).  Group ids must be the index of the
    group's first slot, and grouped slots must start with equal poses.
    """
    if group is not None:
        group = group.to(torch.int64)
        gradient = torch.zeros_like(gradient).index_add_(0, group, gradient)[group]
        hessian = torch.zeros_like(hessian).index_add_(0, group, hessian)[group]
    return newton.newton_step(gradient.contiguous(), hessian.contiguous(),
                              pose.contiguous(), pcfg.tikhonov_rotation,
                              pcfg.tikhonov_translation)


def _region_terms(pcfg: PipelineConfig, intr, scale, points, poses, n_lines,
                  bin_crop, rtab, corner_u, corner_v, width, height,
                  region_check=None, measured_occlusion=None, modeled_occlusion=None,
                  handle_occlusions=None):
    """One correspondence pass for the whole batch -> lane-major DataLines.

    ``handle_occlusions`` is a (B,) bool (per body, so the reference's per-modality
    n_unoccluded_iterations counter maps onto batch entries)."""
    fu, fv, ppu, ppv = _intrinsics(intr)
    cfg = pcfg.cfg
    kp = region_fast.round_up(cfg.line_length_in_segments * scale, 8)
    timing.stage("line_geometry")
    geo = region_fast.line_geometry(
        cfg, scale, points, n_lines, poses, fu, fv, ppu, ppv, width, height,
        corner_u, corner_v, pcfg.crop_size, pcfg.lp, region_check=region_check,
        measured_occlusion=measured_occlusion, modeled_occlusion=modeled_occlusion,
        handle_occlusions=handle_occlusions)
    timing.stage("sample_lines")
    samples = region_fast.sample_lines(geo.params, bin_crop, rtab, kp)
    timing.stage("lines")
    return region_fast.lines_from_samples(cfg, scale, geo, samples)


def _histogram_memories(pcfg: PipelineConfig, intr, points, poses, n_lines,
                        bin_crop, corner_u, corner_v, width, height):
    """Fg/bg color collection along contour normals (cpp:1025-1155) for the batch."""
    fu, fv, ppu, ppv = _intrinsics(intr)
    cfg = pcfg.cfg
    lp2 = 2 * pcfg.lp
    params, mask = region_fast.histogram_walk_geometry(
        cfg, points, n_lines, poses, fu, fv, ppu, ppv, width, height,
        corner_u, corner_v, pcfg.crop_size, lp2)
    kp2 = mask.shape[-1]
    timing.stage("histogram_count")
    bins = region_fast.sample_lines(params, bin_crop, None, kp2, output="bins")
    bins = bins.transpose(1, 2)  # (B, lp2, kp2) to align with mask
    b = bins.shape[0]
    half = lp2 // 2
    n_total = cfg.n_histogram_bins ** 3
    mem_f = region_fast.bin_counts(bins[:, :half].reshape(b, -1),
                                   mask[:, :half].reshape(b, -1).contiguous(), n_total)
    mem_b = region_fast.bin_counts(bins[:, half:].reshape(b, -1),
                                   mask[:, half:].reshape(b, -1).contiguous(), n_total)
    return mem_f, mem_b


def _image_size(images):
    planar_shape = _planar_u8(images).shape
    return planar_shape[3], planar_shape[2]


class _DepthInputs(NamedTuple):
    """The depth side of the RGB-D cycle: images, camera and per-body crop corners."""

    images: torch.Tensor  # (B, Hd, Wd) uint16
    intr: tuple  # (fu, fv, ppu, ppv)
    scale: float
    model: DepthModelArrays
    corner_u: torch.Tensor | None  # (B,) int32, with use_depth
    corner_v: torch.Tensor | None


def _region_measured_occlusion(pcfg: PipelineConfig, depth: _DepthInputs | None,
                               points: ViewPointsCL, pose):
    """The region lines' measured-occlusion inputs (region_modality.cpp:1343-1389):
    windows presampled by the sample_windows kernel when depth fusion is on, else
    gathered from the full depth images."""
    if depth is None or not pcfg.region_measure_occlusions:
        return None
    dfu, dfv, dppu, dppv = depth.intr
    height, width = depth.images.shape[1], depth.images.shape[2]
    presampled = None
    if depth.corner_u is not None:
        timing.stage("measured_occlusion")
        presampled = depth_fast.presample_occlusion_windows(
            pcfg.cfg.measured_occlusion_radius, False, points.center_f_body.transpose(1, 2),
            pose, depth.images, depth.corner_u, depth.corner_v, pcfg.crop_size,
            dfu, dfv, dppu, dppv, width, height)
    return MeasuredOcclusionInputs(depth.images, pose, dfu, dfv, dppu, dppv, depth.scale,
                                   presampled)


def _render_scene_for(pcfg: PipelineConfig, scene_geom, scene_poses, intr, width: int,
                      height: int):
    """Per-iteration scene evaluation: SceneCoeffs (query mode) or FocusedRender."""
    if pcfg.occlusion_queries:
        return occlusion.focused_scene_coeffs(
            scene_geom, scene_poses, intr, width, height, pcfg.focused_image_size,
            pcfg.z_min, pcfg.z_max)
    return occlusion.focused_render(
        scene_geom, scene_poses, intr, width, height, pcfg.focused_image_size,
        pcfg.z_min, pcfg.z_max, pcfg.occlusion_raster_chunk)


def _scene_region_inputs(pcfg: PipelineConfig, rend, scene_geom):
    """RegionCheck/ModeledOcclusion inputs from either scene-evaluation mode."""
    region_check = modeled = None
    if rend is None:
        return region_check, modeled
    if isinstance(rend, occlusion.SceneCoeffs):
        size = pcfg.focused_image_size
        if pcfg.region_checking:
            region_check = RegionCheckQueryInputs(
                rend.coeffs, rend.tri_valid, rend.sil_id & 255, rend.corner_u,
                rend.corner_v, rend.scale, scene_geom.region_id, rend.body_visible, size)
        if pcfg.region_model_occlusions:
            modeled = ModeledOcclusionQueryInputs(
                rend.coeffs, rend.tri_valid, rend.corner_u, rend.corner_v, rend.scale,
                rend.body_visible, size)
        return region_check, modeled
    if pcfg.region_checking:
        region_check = RegionCheckInputs(rend.region_sil, rend.corner_u, rend.corner_v,
                                         rend.scale, scene_geom.region_id,
                                         rend.body_visible)
    if pcfg.region_model_occlusions:
        modeled = ModeledOcclusionInputs(rend.depth, rend.corner_u, rend.corner_v,
                                         rend.scale, rend.body_visible)
    return region_check, modeled


def _scene_depth_inputs(pcfg: PipelineConfig, rend, scene_geom):
    """DepthModeledOcclusion/SilhouetteCheck inputs from either mode."""
    d_modeled = d_sil = None
    if rend is None:
        return d_modeled, d_sil
    if isinstance(rend, occlusion.SceneCoeffs):
        size = pcfg.focused_image_size
        if pcfg.depth_model_occlusions:
            d_modeled = depth_fn.DepthModeledOcclusionQueryInputs(
                rend.coeffs, rend.tri_valid, rend.corner_u, rend.corner_v, rend.scale,
                rend.body_visible, size)
        if pcfg.depth_silhouette_check:
            d_sil = depth_fn.SilhouetteCheckQueryInputs(
                rend.coeffs, rend.tri_valid, rend.sil_id >> 8, rend.corner_u,
                rend.corner_v, rend.scale, scene_geom.body_id, rend.body_visible, size)
        return d_modeled, d_sil
    if pcfg.depth_model_occlusions:
        d_modeled = depth_fn.DepthModeledOcclusionInputs(
            rend.depth, rend.corner_u, rend.corner_v, rend.scale, rend.body_visible)
    if pcfg.depth_silhouette_check:
        d_sil = depth_fn.SilhouetteCheckInputs(
            rend.body_sil, rend.corner_u, rend.corner_v, rend.scale, scene_geom.body_id,
            rend.body_visible)
    return d_modeled, d_sil


def _depth_terms(pcfg: PipelineConfig, depth: _DepthInputs, corr_iteration: int, pose,
                 handle_occlusions, modeled_occlusion=None, silhouette_check=None,
                 n_points=None, body=None):
    """One depth correspondence pass for the batch (depth_modality.cpp:252-315), the
    windows fetched from the depth frames by the sample_windows kernel.  n_points: the
    (B,) per-body point budget, None for depth_cfg.n_points_max; body: the depth model
    row of every batch entry (see _select_view_cl)."""
    cd, _ = pcfg.iteration_depth(corr_iteration)
    dfu, dfv, dppu, dppv = depth.intr
    height, width = depth.images.shape[1], depth.images.shape[2]
    view = _select_depth_view(depth.model, pose, body)
    presampled = depth_fast.presample_windows(
        pcfg.depth_cfg, cd, view.center_f_body, pose, depth.images, depth.corner_u,
        depth.corner_v, pcfg.crop_size, dfu, dfv, dppu, dppv)
    measured = None
    if pcfg.depth_measure_occlusions:
        timing.stage("measured_occlusion")
        measured = depth_fast.presample_occlusion_windows(
            pcfg.depth_cfg.measured_occlusion_radius, pcfg.depth_cfg.use_depth_scaling,
            view.center_f_body, pose, depth.images, depth.corner_u, depth.corner_v,
            pcfg.crop_size, dfu, dfv, dppu, dppv, width, height)
        timing.stage("depth_correspondences")
    return depth_fn.calculate_correspondences(
        pcfg.depth_cfg, cd, view,
        pcfg.depth_cfg.n_points_max if n_points is None else n_points, pose, depth.images,
        dfu, dfv, dppu, dppv, width, height, depth.scale, handle_occlusions,
        measure_occlusions=pcfg.depth_measure_occlusions,
        modeled_occlusion=modeled_occlusion, silhouette_check=silhouette_check,
        presampled=presampled, measured_presampled=measured)


class _Poses(NamedTuple):
    """How a cycle's degrees of freedom become body poses, and how a Newton step
    moves them: rigid bodies carry their (B, 4, 4) poses, articulated structures their
    (S, NL, 4, 4) joint poses."""

    flat: Callable  # dof -> (B, 4, 4) body2camera poses
    scene: Callable  # (B, 4, 4) poses -> (B, NO, 4, 4) poses of each scene's bodies
    step: Callable  # (dof, gradient (B, 6), hessian (B, 6, 6)) -> dof


# The cycles' stages (utils/timing.stage) and the phase of M3T's tracking step each
# belongs to (the evaluators' ExecutionTimes, rbot_evaluator.h:50-56).  A stage is marked
# where it begins; the next mark ends it.
STAGE_PHASES = {
    "crops": "calculate_correspondences",  # _prepare_crops, ratio_table
    "scene_render": "calculate_correspondences",  # the focused scene at the pose
    "view": "calculate_correspondences",  # _select_view_cl, _adaptive_n_lines
    "line_geometry": "calculate_correspondences",  # region_fast.line_geometry
    "sample_lines": "calculate_correspondences",  # K1, ratio mode
    "lines": "calculate_correspondences",  # lines_from_samples
    "depth_correspondences": "calculate_correspondences",  # corners, K3, depth terms
    # K3 on the measured-occlusion windows of the region lines and the depth points
    # (marked only where measured occlusions are on).
    "measured_occlusion": "calculate_correspondences",
    "gradient_hessian": "calculate_gradient_and_hessian",  # gradient_hessian_cl
    "depth_gradient_hessian": "calculate_gradient_and_hessian",
    "texture_gradient_hessian": "calculate_gradient_and_hessian",
    "camera_sum": "calculate_gradient_and_hessian",  # the cameras' terms summed
    "newton_step": "calculate_optimization",  # poses.step
    # The KKT step of the articulated cycles (ops/kinematics.update_structures).
    "kinematic_terms": "calculate_optimization",  # kinematics, Jacobians, constraints
    "kkt_solve": "calculate_optimization",  # the batched solve, the pose update
    "histogram_walk": "calculate_results",  # the last view, histogram_walk_geometry
    "histogram_count": "calculate_results",  # K1 in bins mode, both K2 calls
    "histogram_blend": "calculate_results",  # both calculate_histogram calls
}


def _per_entry(value, n: int, device):
    """A per-batch-entry input (a scalar, or a tensor that broadcasts to (n,)) as an
    (n,) tensor on device, with torch.as_tensor's dtype.  A scalar is filled on the
    device, so that a graph can capture it (no copy from the host)."""
    if isinstance(value, torch.Tensor) or np.ndim(value) > 0:
        return torch.as_tensor(value, device=device).expand(n)
    return torch.full((n,), value, dtype=torch.as_tensor(value).dtype, device=device)


def _cycle_core(pcfg: PipelineConfig, intr, images, model: RegionModelArrays, dof,
                hist_f, hist_b, poses: _Poses, depth: _DepthInputs | None = None,
                scene_geom=None, handle_occlusions=None, texture_points=None,
                depth_n_points=None, model_index=None):
    """Full tracking cycle for a batch (the JAX package's _cycle_core, :519-662, the
    loop of its tracking_cycle_kinematic, :1384-1468, and that of its two sharded
    multi-camera cycles, :756-1288).  The body poses are recomputed from the degrees of
    freedom before every correspondence and update iteration and before the histogram
    walk.  handle_occlusions: a bool or a (B,) bool; None means True.  model_index (B,)
    int64: the row of the region and depth models that each batch entry reads (None:
    its own).  Returns (dof, hist_f, hist_b).

    The cycle marks its stages (utils/timing.stage; STAGE_PHASES lists them), which
    tile it from the first mark to the end of the cycle."""
    timing.stage("crops")
    cfg = pcfg.cfg
    fu, fv, ppu, ppv = _intrinsics(intr)
    width, height = _image_size(images)
    use_depth = depth is not None and depth.corner_u is not None
    use_texture = pcfg.use_texture and texture_points is not None
    render_scene = pcfg.needs_scene_render and scene_geom is not None
    pose = poses.flat(dof)
    n_bodies = pose.shape[0]
    if handle_occlusions is None:
        handle_occlusions = True
    dev = pose.device
    handle_occlusions = _per_entry(handle_occlusions, n_bodies, dev)
    if depth_n_points is not None:
        depth_n_points = _per_entry(depth_n_points, n_bodies, dev)

    bin_crop, corner_u, corner_v = _prepare_crops(pcfg, intr, images, pose)
    rtab = region_fast.ratio_table(hist_f, hist_b)

    for corr_iteration in range(pcfg.n_corr_iterations):
        scale, std = pcfg.iteration_scale(corr_iteration)
        timing.stage("scene_render" if render_scene else "view")
        pose = poses.flat(dof)
        # Correspondence renderers StartRendering (tracker.cpp:448-451): the full scene
        # at the current pose estimate.
        rend = None
        if render_scene:
            rend = _render_scene_for(pcfg, scene_geom, poses.scene(pose), intr, width,
                                     height)
            timing.stage("view")
        points = _select_view_cl(model, pose, model_index)
        n_lines = _adaptive_n_lines(pcfg, model, pose, model_index)
        region_check, modeled = _scene_region_inputs(pcfg, rend, scene_geom)
        measured = _region_measured_occlusion(pcfg, depth, points, pose)
        lines = _region_terms(pcfg, intr, scale, points, pose, n_lines,
                              bin_crop, rtab, corner_u, corner_v, width, height,
                              region_check=region_check, measured_occlusion=measured,
                              modeled_occlusion=modeled,
                              handle_occlusions=handle_occlusions)
        if use_depth:
            timing.stage("depth_correspondences")
            d_modeled, d_sil = _scene_depth_inputs(pcfg, rend, scene_geom)
            depth_points = _depth_terms(pcfg, depth, corr_iteration, pose,
                                        handle_occlusions, d_modeled, d_sil,
                                        depth_n_points, model_index)
            depth_std = pcfg.iteration_depth(corr_iteration)[1]
        if use_texture:
            texture_std = pcfg.iteration_texture_std(corr_iteration)
        for update_iteration in range(pcfg.n_update_iterations):
            timing.stage("gradient_hessian")
            pose = poses.flat(dof)
            gradient, hessian = region_fast.gradient_hessian_cl(
                cfg, lines, pose, fu, fv, ppu, ppv, std,
                update_iteration < cfg.n_global_iterations)
            if use_depth:
                timing.stage("depth_gradient_hessian")
                dg, dh = depth_fn.calculate_gradient_and_hessian(depth_points, pose,
                                                                 depth_std)
                gradient = gradient + dg
                hessian = hessian + dh
            if use_texture:
                timing.stage("texture_gradient_hessian")
                tg, th = texture_fn.calculate_gradient_and_hessian(
                    texture_points, pose, fu, fv, ppu, ppv, texture_std,
                    pcfg.tukey_norm_constant)
                gradient = gradient + tg
                hessian = hessian + th
            timing.stage("newton_step")
            dof = poses.step(dof, gradient, hessian)

    # CalculateResults: online histogram adaptation (tracker.cpp:503-517).
    timing.stage("histogram_walk")
    pose = poses.flat(dof)
    points = _select_view_cl(model, pose, model_index)
    n_lines = _adaptive_n_lines(pcfg, model, pose, model_index)
    mem_f, mem_b = _histogram_memories(pcfg, intr, points, pose, n_lines,
                                       bin_crop, corner_u, corner_v, width, height)
    timing.stage("histogram_blend")
    hist_f = hist_ops.calculate_histogram(hist_f, mem_f, pcfg.learning_rate_f)
    hist_b = hist_ops.calculate_histogram(hist_b, mem_b, pcfg.learning_rate_b)
    return dof, hist_f, hist_b


def _rigid_cycle(pcfg: PipelineConfig, intr, images, model: RegionModelArrays,
                 state: TrackingState, occluder_poses=None, pose_group=None,
                 **kwargs) -> TrackingState:
    """_cycle_core for independent rigid bodies, each a pose of its own (or of its
    pose_group)."""
    def scene(pose):
        # The tracked body in slot 0, then the occluders.
        if occluder_poses is None:
            return pose[:, None]
        return torch.cat([pose[:, None], occluder_poses], dim=1)

    def step(pose, gradient, hessian):
        return _solve_and_update(pcfg, gradient, hessian, pose, group=pose_group)

    return TrackingState(*_cycle_core(
        pcfg, intr, images, model, state.body2camera_pose, state.histogram_f,
        state.histogram_b, _Poses(lambda pose: pose, scene, step), **kwargs))


@graphs.graphed(static_argnames=("pcfg",))
def tracking_cycle(pcfg: PipelineConfig, intr, images, model: RegionModelArrays,
                   state: TrackingState, scene_geom=None, occluder_poses=None,
                   handle_occlusions=None, texture_points: TexturePoints | None = None,
                   pose_group=None) -> TrackingState:
    """One full region tracking cycle for a batch of bodies.

    intr: (fu, fv, ppu, ppv); images: (B, H, W, 3) or planar (B, 3, H, W) uint8 on the
    device of the state.  scene_geom (ops.occlusion.SceneGeometry) and occluder_poses
    (B, NO-1, 4, 4) enable the modeled occlusions and region checking that the
    PipelineConfig flags ask for; handle_occlusions (a bool or a (B,) bool, None means
    True) is False for the first iterations after StartModality
    (region_modality.h:442).  texture_points (ops.texture_fn.TexturePoints, leading B)
    adds the texture terms when ``pcfg.use_texture``.  pose_group (B,) ties batch slots
    to one shared pose (see _solve_and_update).
    """
    return _rigid_cycle(pcfg, intr, images, model, state, occluder_poses=occluder_poses,
                        pose_group=pose_group, scene_geom=scene_geom,
                        handle_occlusions=handle_occlusions, texture_points=texture_points)


@graphs.graphed(static_argnames=("pcfg",))
def tracking_cycle_rgbd(pcfg: PipelineConfig, intr, depth_intr, depth_scale, images,
                        depth_images, model: RegionModelArrays,
                        depth_model: DepthModelArrays, state: TrackingState,
                        scene_geom=None, occluder_poses=None, handle_occlusions=None,
                        texture_points: TexturePoints | None = None, pose_group=None,
                        depth_n_points=None) -> TrackingState:
    """ICG-style region+depth fused cycle for a batch of bodies.

    depth_images: (B, Hd, Wd) uint16 with shared depth intrinsics ``depth_intr``
    (fu, fv, ppu, ppv) and ``depth_scale`` (meters per unit), registered to the colour
    camera (the reference's ICG configuration, ICG/readme.md:51-73).  Depth terms are
    fused when ``pcfg.use_depth``; measured occlusions on either modality follow
    ``pcfg.region_measure_occlusions`` and ``pcfg.depth_measure_occlusions``; the
    focused scene's checks of both modalities follow the other occlusion flags.
    depth_n_points (B,) int sets the per-slot depth point budget (0 drops the depth terms
    of the non-primary slots of a pose_group, which all duplicate one DepthModality).
    scene_geom, occluder_poses, handle_occlusions, texture_points and pose_group as in
    :func:`tracking_cycle`.
    """
    pose = state.body2camera_pose
    corner_u = corner_v = None
    if pcfg.use_depth:
        timing.stage("depth_correspondences")
        corner_u, corner_v = depth_fast.depth_corners(
            depth_images, pose, *_intrinsics(depth_intr), pcfg.crop_size)
    depth = _DepthInputs(depth_images, _intrinsics(depth_intr), float(depth_scale),
                         depth_model, corner_u, corner_v)
    return _rigid_cycle(pcfg, intr, images, model, state, occluder_poses=occluder_poses,
                        pose_group=pose_group, depth=depth, scene_geom=scene_geom,
                        handle_occlusions=handle_occlusions, texture_points=texture_points,
                        depth_n_points=depth_n_points)


def initialize_histograms(pcfg: PipelineConfig, intr, images, model: RegionModelArrays,
                          poses) -> TrackingState:
    """StartModality for the batch: build histograms at the initial poses (lr == 1)."""
    return _start_histograms(pcfg, intr, images, model, poses)


def _start_histograms(pcfg: PipelineConfig, intr, images, model: RegionModelArrays, poses,
                      model_index=None) -> TrackingState:
    """initialize_histograms, each batch entry reading model row model_index (see
    _cycle_core)."""
    cfg = pcfg.cfg
    width, height = _image_size(images)
    n = cfg.n_histogram_bins ** 3
    b = poses.shape[0]

    bin_crop, corner_u, corner_v = _prepare_crops(pcfg, intr, images, poses)
    points = _select_view_cl(model, poses, model_index)
    mem_f, mem_b = _histogram_memories(pcfg, intr, points, poses,
                                       _adaptive_n_lines(pcfg, model, poses, model_index),
                                       bin_crop, corner_u, corner_v, width, height)
    uniform = torch.full((b, n), 1.0 / n, dtype=torch.float32, device=poses.device)
    hist_f = hist_ops.calculate_histogram(uniform, mem_f, 1.0)
    hist_b = hist_ops.calculate_histogram(uniform, mem_b, 1.0)
    return TrackingState(poses, hist_f, hist_b)


def texture_points_from_modalities(modalities, k_max: int, device="cuda") -> TexturePoints:
    """Pack host TextureModality correspondences into a fixed-shape TexturePoints.

    Call each modality's CalculateCorrespondences first (feature detection and keyframe
    matching run on the host); this pads or truncates each modality's matched 3D-2D
    pairs (``data_points_3d``, ``data_points_2d``) to ``k_max``."""
    dev = resolve_device(device)
    b = len(modalities)
    p3 = np.zeros((b, k_max, 3), np.float32)
    p2 = np.zeros((b, k_max, 2), np.float32)
    valid = np.zeros((b, k_max), bool)
    for i, m in enumerate(modalities):
        n = min(len(m.data_points_3d), k_max)
        p3[i, :n] = m.data_points_3d[:n]
        p2[i, :n] = m.data_points_2d[:n]
        valid[i, :n] = True
    return TexturePoints(*(torch.as_tensor(a, device=dev) for a in (p3, p2, valid)))


# ----------------------------------------------------------------------------------------
# Articulated structures: kinematic trees in the fused cycle
# ----------------------------------------------------------------------------------------


class KinematicTrackingState(NamedTuple):
    """Per-structure tracking state: joint poses and per-link histograms.

    ``joint2parent`` follows ops/kinematics.py's convention (the root link's parent
    frame is the camera frame); bodies are flattened link-major, body b == s * NL + l
    for structure s, link l."""

    joint2parent: torch.Tensor  # (S, NL, 4, 4)
    histogram_f: torch.Tensor  # (S, NL, n_bins^3)
    histogram_b: torch.Tensor  # (S, NL, n_bins^3)


def _kinematic_flat_poses(kin: kin_ops.KinematicModel, joint2parent):
    """Link poses (S, NL, 4, 4) and the same flattened to bodies (S * NL, 4, 4)."""
    b2c = kin_ops.forward_kinematics(kin, joint2parent)
    return b2c, b2c.reshape((-1, 4, 4))


def _repeat_each(x, n: int):
    """Each entry of x (S, ...) repeated n times in a row, (S * n, ...): per-structure
    frames for each link, or per-body records for each camera.  A view when x is one
    entry expanded over S; otherwise a copy, as jnp.repeat makes one."""
    return x[:, None].expand((x.shape[0], n) + x.shape[1:]).reshape((-1,) + x.shape[1:])


@graphs.graphed(static_argnames=("pcfg",))
def tracking_cycle_kinematic(pcfg: PipelineConfig, intr, images, model: RegionModelArrays,
                             kin: kin_ops.KinematicModel, state: KinematicTrackingState,
                             scene_geom=None, extra_occluder_poses=None,
                             handle_occlusions=None, depth_intr=None, depth_scale=None,
                             depth_images=None, depth_model: DepthModelArrays | None = None,
                             texture_points: TexturePoints | None = None
                             ) -> KinematicTrackingState:
    """One tracking cycle for S articulated structures of NL links each (Tracker::
    ExecuteTrackingStep over kinematic structures, tracker.cpp:344-364 with
    optimizer.cpp:144-167): per-link region (and depth and texture) terms feed the
    batched KKT solve of ops/kinematics.py, with the structures' hard and soft
    constraints, every update iteration.

    images: (S, H, W, 3) or planar (S, 3, H, W) uint8, one camera per structure.
    model: RegionModelArrays with B == S * NL link-major bodies (any model pads a missing
    link; kin.link_valid masks its terms).  scene_geom: SceneGeometry with B scenes
    whose body slots 0..NL-1 are the structure's links and slots NL.. static occluders
    posed by extra_occluder_poses (S, NE, 4, 4): the links occlude one another.
    depth_intr, depth_scale, depth_images (S, Hd, Wd) uint16 and depth_model (B bodies)
    add per-link depth terms when ``pcfg.use_depth`` (the Mb-ICG/RTB configuration,
    link.cpp:184-193), always with depth_cfg.n_points_max points.  texture_points
    (leading B) add texture terms when ``pcfg.use_texture``.  As in the reference, the
    region lines take no measured occlusions here.  Each call counts its structures,
    links and KKT rows (kin_ops.count_work).
    """
    s, nl = kin.parent.shape
    n_hist = state.histogram_f.shape[-1]
    kin_ops.count_work(kin)
    depth = None
    if pcfg.use_depth and depth_images is not None:
        timing.stage("depth_correspondences")
        depth_flat = _repeat_each(depth_images, nl)
        _, pose_flat = _kinematic_flat_poses(kin, state.joint2parent)
        corner_u, corner_v = depth_fast.depth_corners(
            depth_flat, pose_flat, *_intrinsics(depth_intr), pcfg.crop_size)
        depth = _DepthInputs(depth_flat, _intrinsics(depth_intr), float(depth_scale),
                             depth_model, corner_u, corner_v)

    def scene(pose):
        # Every link's scene holds the whole structure (and the extra occluders).
        scene_poses = pose.reshape(s, 1, nl, 4, 4).expand(s, nl, nl, 4, 4)
        if extra_occluder_poses is not None:
            ne = extra_occluder_poses.shape[1]
            scene_poses = torch.cat(
                [scene_poses, extra_occluder_poses[:, None].expand(s, nl, ne, 4, 4)], dim=2)
        return scene_poses.reshape(s * nl, -1, 4, 4)

    def step(joint2parent, gradient, hessian):
        return kin_ops.update_structures(
            kin, joint2parent, gradient.reshape(s, nl, 6), hessian.reshape(s, nl, 6, 6),
            pcfg.tikhonov_rotation, pcfg.tikhonov_translation)

    jp, hist_f, hist_b = _cycle_core(
        pcfg._replace(region_measure_occlusions=False), intr, _repeat_each(images, nl),
        model, state.joint2parent, state.histogram_f.reshape(s * nl, n_hist),
        state.histogram_b.reshape(s * nl, n_hist),
        _Poses(lambda joint2parent: _kinematic_flat_poses(kin, joint2parent)[1], scene,
               step),
        depth=depth, scene_geom=scene_geom, handle_occlusions=handle_occlusions,
        texture_points=texture_points)
    return KinematicTrackingState(jp, hist_f.reshape(s, nl, n_hist),
                                  hist_b.reshape(s, nl, n_hist))


def initialize_kinematic_histograms(pcfg: PipelineConfig, intr, images,
                                    model: RegionModelArrays, kin: kin_ops.KinematicModel,
                                    joint2parent) -> KinematicTrackingState:
    """StartModality for articulated structures: histograms at the initial joint poses
    (S, NL, 4, 4); images (S, ...) as in :func:`tracking_cycle_kinematic`."""
    s, nl = joint2parent.shape[:2]
    _, pose_flat = _kinematic_flat_poses(kin, joint2parent)
    st = initialize_histograms(pcfg, intr, _repeat_each(images, nl), model, pose_flat)
    return KinematicTrackingState(joint2parent, st.histogram_f.reshape(s, nl, -1),
                                  st.histogram_b.reshape(s, nl, -1))


def kinematic_body_poses(kin: kin_ops.KinematicModel, state: KinematicTrackingState):
    """Per-link body2camera poses (S, NL, 4, 4) of the joint state."""
    return _kinematic_flat_poses(kin, state.joint2parent)[0]


# ----------------------------------------------------------------------------------------
# Multi-camera fusion over a (data, camera) mesh of processes
# ----------------------------------------------------------------------------------------
#
# The JAX package's make_sharded_cycle and make_sharded_kinematic_cycle
# (m3t_tpu/pipeline.py:756-1288) shard_map one jitted function over global arrays.  A
# torch.distributed process holds only its own shard, so the cycles below take each
# rank's local shard: the bodies (or structures) of its data index, seen by the cameras
# of its camera index.  With mesh=None one process holds every body and camera.  The
# batch is flattened in the JAX package's order, (body, camera) or (structure, link,
# camera), and runs through _cycle_core like every other cycle: a camera fan-out is one
# more _Poses.  The models are read by row (model_index), not copied per camera.


class MultiCameraState(NamedTuple):
    """State of the multi-camera cycle: the pose of each body in the reference camera's
    frame, and histograms per (body, camera), as the reference gives each
    RegionModality its own ColorHistograms (region_modality.h:79-83)."""

    body2reference_pose: torch.Tensor  # (B, 4, 4)
    histogram_f: torch.Tensor  # (B, C, n_bins^3)
    histogram_b: torch.Tensor  # (B, C, n_bins^3)


class KinematicMultiCameraState(NamedTuple):
    """State of the multi-camera articulated cycle: joint poses with the root's parent
    frame the reference camera's, and histograms per (structure, link, camera)."""

    joint2parent: torch.Tensor  # (S, NL, 4, 4)
    histogram_f: torch.Tensor  # (S, NL, C, n_bins^3)
    histogram_b: torch.Tensor  # (S, NL, C, n_bins^3)


def _ref2cam(cam2ref_poses):
    """The cameras' reference-to-camera poses (C, 4, 4), inverted in float64 (the values
    of torch.linalg.inv, without its check of the factorization on the host)."""
    return torch.linalg.inv_ex(cam2ref_poses.to(torch.float64), check_errors=False).inverse


def _in_cameras(ref2cam, poses):
    """Reference-frame poses (N, ..., 4, 4) in each camera's frame, (N, C, ..., 4, 4):
    the JAX cycles' einsum("cij,b...jk->bc...ik").  The products are taken in float64
    (exact for float32 factors) and rounded once to float32, so that a pose's value
    depends neither on the batch around it nor on the device's matmul (but for a
    float64 sum within its own rounding error of a float32 rounding boundary).  On an
    NVIDIA H100 this took the rigid multi-camera cycle's difference from the CPU at B=8,
    C=2 from 8e-4 (one body parted) to 2.3e-7."""
    extra = poses.dim() - 3
    cams = ref2cam.reshape(ref2cam.shape[:1] + (1,) * extra + (4, 4))
    return torch.matmul(cams, poses[:, None].to(torch.float64)).to(poses.dtype)


def _camera_sum(mesh, gradient, hessian, lead: tuple):
    """Body-frame terms (flat (..., camera) order, leading shape ``lead``) summed over the
    local cameras, then over the mesh's camera group (the JAX package's psum over
    "camera", m3t_tpu/pipeline.py:948-949): (lead[:-1] + (6,), lead[:-1] + (6, 6)).
    Gradient and Hessian travel in one all_reduce, which a graph runs between two of
    its segments (graphs.collective); a group of one rank is skipped."""
    timing.stage("camera_sum")
    g = gradient.reshape(lead + (6,)).sum(-2)
    h = hessian.reshape(lead + (6, 6)).sum(-3)
    if mesh is not None and mesh.n_camera > 1:
        both = torch.cat([g.reshape(-1), h.reshape(-1)])
        graphs.collective(functools.partial(torch.distributed.all_reduce,
                                            group=mesh.camera_group), both)
        g, h = both[:g.numel()].view(g.shape), both[g.numel():].view(h.shape)
    timing.stage("newton_step")
    return g, h


def _split_extra(extra, with_depth: bool, with_scene: bool, with_texture: bool):
    """The cycles' optional inputs in the JAX package's order (m3t_tpu/pipeline.py:
    778-787): (depth_images, depth_scale, depth_model), (scene_geom, occluder_poses),
    texture_points; None for each group that is off."""
    extra = list(extra)
    want = 3 * with_depth + 2 * with_scene + with_texture
    if len(extra) != want:
        raise ValueError(f"the cycle takes {want} extra inputs, got {len(extra)}")
    depth = tuple(extra[:3]) if with_depth else (None,) * 3
    extra = extra[3 * with_depth:]
    scene = tuple(extra[:2]) if with_scene else (None,) * 2
    texture = extra[2 * with_scene] if with_texture else None
    return depth, scene, texture


def _flat_depth(pcfg: PipelineConfig, depth_intr, depth, flat_pose):
    """The depth side of a multi-camera cycle: depth = (frames of the flat batch (B,
    Hd, Wd), depth_scale, depth_model) or Nones; crop corners from the flat per-camera
    poses (the JAX cycles' depth crops, m3t_tpu/pipeline.py:850)."""
    depth_images, depth_scale, depth_model = depth
    if depth_images is None:
        return None
    timing.stage("depth_correspondences")
    corner_u, corner_v = depth_fast.depth_corners(
        depth_images, flat_pose, *_intrinsics(depth_intr), pcfg.crop_size)
    return _DepthInputs(depth_images, _intrinsics(depth_intr), float(depth_scale),
                        depth_model, corner_u, corner_v)


def _flat_texture(texture_points, n_lead: int):
    if texture_points is None:
        return None
    return TexturePoints(*(a.reshape((-1,) + a.shape[n_lead:]) for a in texture_points))


def _flat_handle(handle_occlusions, n_cameras: int, device):
    """Per-body (or per-link) flags repeated for each camera; None means True, and a
    bool stays one (_cycle_core fills it on the device)."""
    if handle_occlusions is None or np.ndim(handle_occlusions) == 0:
        return handle_occlusions
    handle = torch.as_tensor(handle_occlusions, device=device).reshape(-1)
    return _repeat_each(handle, n_cameras)


def _bound_cycle(fn, arguments):
    """The cycle a make_sharded_* function returns: fn (a graphed function) called with
    arguments(*args, **kwargs), the cycle's own arguments and what it was built from;
    ``cycle.static_key(*args, **kwargs)`` is that call's static key."""
    def cycle(*args, **kwargs):
        return fn(**arguments(*args, **kwargs))

    cycle.static_key = lambda *args, **kwargs: graphs.static_key(fn, **arguments(*args,
                                                                                  **kwargs))
    return cycle


def _built_from(pcfg, mesh, intr, depth_intr, with_depth, with_scene, with_texture) -> dict:
    """What a multi-camera cycle is built from, the intrinsics as tuples of floats (the
    values its graph bakes in and is keyed on)."""
    return dict(pcfg=pcfg, mesh=mesh, intr=_intrinsics(intr),
                depth_intr=None if depth_intr is None else _intrinsics(depth_intr),
                with_depth=with_depth, with_scene=with_scene, with_texture=with_texture)


_SHARDED_STATIC = ("pcfg", "mesh", "with_depth", "with_scene", "with_texture")


def make_sharded_cycle(pcfg: PipelineConfig, mesh, intr, depth_intr=None,
                       with_depth: bool = False, with_scene: bool = False,
                       with_texture: bool = False):
    """The multi-camera rigid cycle (m3t_tpu/pipeline.py:756): every body is observed
    by several cameras whose body-frame gradient and Hessian terms are summed, over the
    local cameras and then over the mesh's camera group, before the shared Newton step
    (one Link summing the modalities of several cameras, link.cpp:184-193).  Each
    camera runs the full cycle: every correspondence and update iteration, its own
    histograms, depth fusion (``with_depth``), the focused scene's checks
    (``with_scene`` and the PipelineConfig's occlusion flags) and texture terms
    (``with_texture``).  With one camera at cam2ref = I the result equals
    :func:`tracking_cycle_rgbd` (or :func:`tracking_cycle`) bit for bit.

    mesh: a :func:`m3t_tpu_torch.parallel.make_mesh` mesh, or None for one process.
    The returned ``cycle(images, cam2ref_poses, model, state, *extra,
    handle_occlusions=None) -> MultiCameraState`` takes this rank's LOCAL shard, where
    the JAX cycle takes global arrays that shard_map slices (a torch.distributed process
    holds only its own shard; parallel.shard_over cuts one from global tensors):

      images (b, c, H, W, 3) or planar (b, c, 3, H, W) uint8 of the local bodies and
      cameras; cam2ref_poses (c, 4, 4) camera-to-reference extrinsics of the local
      cameras; model RegionModelArrays of the b local bodies; state MultiCameraState with
      histograms (b, c, N); handle_occlusions (b,) bool or a bool, None for True.
      with_depth adds (depth_images (b, c, Hd, Wd) uint16, depth_scale, depth_model
      DepthModelArrays of b bodies): the depth terms are fused whenever with_depth is
      set (the JAX cycle does not read pcfg.use_depth), and measured occlusions of
      either modality follow the PipelineConfig flags (:869-882).  with_scene adds
      (scene_geom SceneGeometry of b scenes, occluder_poses (b, NO-1, 4, 4) in the
      REFERENCE frame, mapped into each camera once per cycle).  with_texture adds
      texture_points (TexturePoints with leading (b, c)).

    The cycle is graphed as the JAX package jits it (m3t_tpu/pipeline.py:991): on the
    card one CUDA graph per static key, made of what the cycle was built from (by value:
    cycles built from equal arguments share one graph) and of the call's own arguments
    (``cycle.static_key``); on the CPU and under graphs.disable_graphs() it runs eagerly.
    """
    built = _built_from(pcfg, mesh, intr, depth_intr, with_depth, with_scene, with_texture)

    def arguments(images, cam2ref_poses, model: RegionModelArrays, state: MultiCameraState,
                  *extra, handle_occlusions=None) -> dict:
        return dict(built, images=images, cam2ref_poses=cam2ref_poses, model=model,
                    state=state, extra=extra, handle_occlusions=handle_occlusions)

    return _bound_cycle(_sharded_cycle, arguments)


@graphs.graphed(static_argnames=_SHARDED_STATIC)
def _sharded_cycle(pcfg: PipelineConfig, mesh, intr, depth_intr, with_depth: bool,
                   with_scene: bool, with_texture: bool, images, cam2ref_poses,
                   model: RegionModelArrays, state: MultiCameraState, extra,
                   handle_occlusions) -> MultiCameraState:
    """The cycle of :func:`make_sharded_cycle`, with what it was built from."""
    depth, (scene_geom, occluder_poses), texture_points = _split_extra(
        extra, with_depth, with_scene, with_texture)
    b, c = images.shape[:2]
    n_hist = state.histogram_f.shape[-1]
    ref2cam = _ref2cam(cam2ref_poses)

    def flat(pose):
        # The body's pose in each camera's frame, (body, camera) order.
        return _in_cameras(ref2cam, pose).reshape(b * c, 4, 4)

    occluders = None
    if occluder_poses is not None:
        occluders = _in_cameras(ref2cam, occluder_poses).reshape(
            (b * c,) + occluder_poses.shape[1:])

    def scene(pose):
        # The (body, camera) pose in slot 0, then the occluders in that camera.
        if occluders is None:
            return pose[:, None]
        return torch.cat([pose[:, None], occluders], dim=1)

    def step(pose, gradient, hessian):
        g, h = _camera_sum(mesh, gradient, hessian, (b, c))
        return _solve_and_update(pcfg, g, h, pose)

    pose = state.body2reference_pose
    model_index = torch.arange(b * c, device=pose.device) // c
    if depth[0] is not None:
        depth = (depth[0].reshape((b * c,) + depth[0].shape[2:]),) + depth[1:]
    if scene_geom is not None:
        scene_geom = type(scene_geom)(*(_repeat_each(a, c) for a in scene_geom))
    pose, hist_f, hist_b = _cycle_core(
        pcfg, intr, images.reshape((b * c,) + images.shape[2:]), model, pose,
        state.histogram_f.reshape(b * c, n_hist), state.histogram_b.reshape(b * c, n_hist),
        _Poses(flat, scene, step),
        depth=_flat_depth(pcfg, depth_intr, depth, flat(pose)),
        scene_geom=scene_geom,
        handle_occlusions=_flat_handle(handle_occlusions, c, pose.device),
        texture_points=_flat_texture(texture_points, 2), model_index=model_index)
    return MultiCameraState(pose, hist_f.reshape(b, c, n_hist),
                            hist_b.reshape(b, c, n_hist))


def initialize_multicamera_histograms(pcfg: PipelineConfig, intr, images, cam2ref_poses,
                                      model: RegionModelArrays, poses) -> MultiCameraState:
    """StartModality for the multi-camera cycle (m3t_tpu/pipeline.py:1004): histograms
    per (body, camera) at the reference-frame poses (b, 4, 4); images and cam2ref_poses
    as :func:`make_sharded_cycle` takes them (a rank's local shard)."""
    b, c = images.shape[:2]
    pose_cam = _in_cameras(_ref2cam(cam2ref_poses), poses)
    st = _start_histograms(pcfg, intr, images.reshape((b * c,) + images.shape[2:]), model,
                           pose_cam.reshape(b * c, 4, 4),
                           torch.arange(b * c, device=poses.device) // c)
    n = st.histogram_f.shape[-1]
    return MultiCameraState(poses, st.histogram_f.reshape(b, c, n),
                            st.histogram_b.reshape(b, c, n))


def make_sharded_kinematic_cycle(pcfg: PipelineConfig, mesh, intr, depth_intr=None,
                                 with_depth: bool = False, with_scene: bool = False,
                                 with_texture: bool = False):
    """The multi-camera articulated cycle (m3t_tpu/pipeline.py:1034): S structures of NL
    links, each structure observed by several cameras whose per-link body-frame terms
    are summed, over the local cameras and then over the mesh's camera group, before
    the batched KKT step of ops/kinematics.py (update_structures).  As in
    :func:`tracking_cycle_kinematic`, the region lines take no measured occlusions.

    mesh: as in :func:`make_sharded_cycle`; the data axis splits S into whole
    structures.  The returned ``cycle(images, cam2ref_poses, model, kin, state, *extra,
    handle_occlusions=None) -> KinematicMultiCameraState`` takes this rank's LOCAL
    shard: images (s, c, H, W, 3) or planar (s, c, 3, H, W) uint8; cam2ref_poses (c, 4,
    4); model RegionModelArrays of the s * NL link-major link bodies; kin the s
    structures' KinematicModel; state KinematicMultiCameraState with histograms (s, NL,
    c, N); handle_occlusions (s, NL) bool or a bool, None for True.  with_depth adds
    (depth_images (s, c, Hd, Wd) uint16, depth_scale, depth_model of s * NL bodies),
    fused whenever with_depth is set; with_scene adds (scene_geom, the s * NL per-link
    scenes of occlusion.build_kinematic_scene_geometry, extra_occluder_poses (s, NE, 4,
    4) in the REFERENCE frame); with_texture adds texture_points with leading (s, NL,
    c).  The frames are repeated for each link (the flat batch's frame of every
    (structure, link, camera)): a copy unless they are one frame expanded, as the JAX
    cycle's jnp.repeat is.  Graphed as :func:`make_sharded_cycle`'s cycle is
    (m3t_tpu/pipeline.py:1270).
    """
    built = _built_from(pcfg, mesh, intr, depth_intr, with_depth, with_scene, with_texture)

    def arguments(images, cam2ref_poses, model: RegionModelArrays,
                  kin: kin_ops.KinematicModel, state: KinematicMultiCameraState, *extra,
                  handle_occlusions=None) -> dict:
        return dict(built, images=images, cam2ref_poses=cam2ref_poses, model=model,
                    kin=kin, state=state, extra=extra, handle_occlusions=handle_occlusions)

    return _bound_cycle(_sharded_kinematic_cycle, arguments)


@graphs.graphed(static_argnames=_SHARDED_STATIC)
def _sharded_kinematic_cycle(pcfg: PipelineConfig, mesh, intr, depth_intr,
                             with_depth: bool, with_scene: bool, with_texture: bool,
                             images, cam2ref_poses, model: RegionModelArrays,
                             kin: kin_ops.KinematicModel, state: KinematicMultiCameraState,
                             extra, handle_occlusions) -> KinematicMultiCameraState:
    """The cycle of :func:`make_sharded_kinematic_cycle`, with what it was built from."""
    depth, (scene_geom, extra_occluder_poses), texture_points = _split_extra(
        extra, with_depth, with_scene, with_texture)
    s, c = images.shape[:2]
    nl = kin.parent.shape[1]
    n = s * nl * c
    n_hist = state.histogram_f.shape[-1]
    ref2cam = _ref2cam(cam2ref_poses)

    def flat(joint2parent):
        # Every link's pose in each camera's frame, (structure, link, camera) order.
        link_poses = kin_ops.forward_kinematics(kin, joint2parent)
        return _in_cameras(ref2cam, link_poses.reshape(s * nl, 4, 4)).reshape(n, 4, 4)

    extras = None
    if extra_occluder_poses is not None:
        extras = _in_cameras(ref2cam, extra_occluder_poses)

    def scene(pose):
        # Each (structure, link, camera) scene: the structure's links in that camera
        # (they occlude each other), then the extra occluders in that camera.
        links = pose.reshape(s, nl, c, 4, 4).transpose(1, 2)     # (s, c, nl, 4, 4)
        scene_poses = links[:, None].expand(s, nl, c, nl, 4, 4)
        if extras is not None:
            ne = extras.shape[2]
            scene_poses = torch.cat(
                [scene_poses, extras[:, None].expand(s, nl, c, ne, 4, 4)], dim=3)
        return scene_poses.reshape(n, -1, 4, 4)

    def step(joint2parent, gradient, hessian):
        g, h = _camera_sum(mesh, gradient, hessian, (s, nl, c))
        return kin_ops.update_structures(kin, joint2parent, g, h, pcfg.tikhonov_rotation,
                                         pcfg.tikhonov_translation)

    jp = state.joint2parent
    model_index = torch.arange(n, device=jp.device) // c

    def per_link(frames):
        # (s, c, ...) -> (s * nl * c, ...) in (structure, link, camera) order.
        return frames[:, None].expand((s, nl) + frames.shape[1:]).reshape(
            (n,) + frames.shape[2:])

    if depth[0] is not None:
        depth = (per_link(depth[0]),) + depth[1:]
    if scene_geom is not None:
        scene_geom = type(scene_geom)(*(_repeat_each(a, c) for a in scene_geom))
    jp, hist_f, hist_b = _cycle_core(
        pcfg._replace(region_measure_occlusions=False), intr, per_link(images), model,
        jp, state.histogram_f.reshape(n, n_hist), state.histogram_b.reshape(n, n_hist),
        _Poses(flat, scene, step),
        depth=_flat_depth(pcfg, depth_intr, depth, flat(jp)),
        scene_geom=scene_geom,
        handle_occlusions=_flat_handle(handle_occlusions, c, jp.device),
        texture_points=_flat_texture(texture_points, 3), model_index=model_index)
    return KinematicMultiCameraState(jp, hist_f.reshape(s, nl, c, n_hist),
                                     hist_b.reshape(s, nl, c, n_hist))
