"""Region-modality configuration, occlusions, region checking and the host path's
per-modality functions (port of m3t_tpu/ops/region_fn.py).

The JAX functions work on one body and are ``vmap``-ed by their caller; here the batch
of bodies is a leading dimension: per-line values are (B, L), per-body values (the crop
parameters and ids of the focused scene) are (B,).  The scene checks take either
point-query inputs (``*QueryInputs``, the focused scene's triangle coefficients from
ops/occlusion.focused_scene_coeffs) or image inputs (rendered focused crops from
ops/occlusion.focused_render); both give the same masks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from m3t_tpu_torch.ops import depth_fn, occlusion
from m3t_tpu_torch.ops import histogram as hist_ops

KN_REGION_STRIDE = 5  # region_modality.h:146
KREGION_OFFSET = 2.0  # region_modality.h:147


class RegionConfig(NamedTuple):
    """Static configuration (defaults: region_modality.h:411-443)."""

    n_lines_max: int = 200
    function_length: int = 8
    distribution_length: int = 12
    function_amplitude: float = 0.43
    function_slope: float = 0.5
    learning_rate: float = 1.3
    n_global_iterations: int = 1
    min_continuous_distance: float = 3.0
    n_histogram_bins: int = 16
    unconsidered_line_length: float = 0.5
    max_considered_line_length: float = 20.0
    measured_occlusion_radius: float = 0.01
    measured_occlusion_threshold: float = 0.03
    modeled_occlusion_radius: float = 0.01
    modeled_occlusion_threshold: float = 0.03
    min_n_unoccluded_lines: int = 0

    @property
    def line_length_in_segments(self) -> int:
        # PrecalculateDistributionVariables (region_modality.cpp:926)
        return self.function_length + self.distribution_length - 1

    @property
    def min_expected_variance(self) -> float:
        # region_modality.cpp:931-935
        laplace = 1.0 / (2.0 * np.arctanh(2.0 * self.function_amplitude) ** 2)
        return float(max(laplace, self.function_slope))

    def function_lookups(self):
        """Smoothed step function lookup tables (PrecalculateFunctionLookup:910-923),
        as float32 numpy arrays."""
        i = np.arange(self.function_length, dtype=np.float32)
        x = i - (self.function_length - 1) / 2.0
        if self.function_slope == 0.0:
            f = 0.5 - self.function_amplitude * np.sign(x)
        else:
            f = 0.5 - self.function_amplitude * np.tanh(x / (2.0 * self.function_slope))
        return np.asarray(f, np.float32), np.asarray(1.0 - f, np.float32)


class MeasuredOcclusionInputs(NamedTuple):
    """Depth images for the region lines' measured-occlusion check, batched."""

    depth_image: torch.Tensor  # (B, H, W) uint16
    body2depth_camera_pose: torch.Tensor  # (B, 4, 4)
    fu: float
    fv: float
    ppu: float
    ppv: float
    depth_scale: float
    # Optional (d (B, L, K, K) raw depth, ok (B, L, K, K)) from
    # ops/depth_fast.presample_occlusion_windows: replaces the window gather from the
    # full image (identical wherever the window lies inside the body-centred crop).
    presampled: tuple | None = None


class ModeledOcclusionInputs(NamedTuple):
    """Rendered focused depth crops for the modeled-occlusion check (image mode)."""

    focused_depth: torch.Tensor  # (B, S, S) f32 meters, +inf background
    corner_u: torch.Tensor  # (B,)
    corner_v: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,)
    body_visible: torch.Tensor  # (B,) bool


class RegionCheckInputs(NamedTuple):
    """Rendered focused region-id crops for region checking (image mode)."""

    silhouette: torch.Tensor  # (B, S, S) int32 region ids
    corner_u: torch.Tensor  # (B,)
    corner_v: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,)
    region_id: torch.Tensor  # (B,) int32
    body_visible: torch.Tensor  # (B,) bool


class ModeledOcclusionQueryInputs(NamedTuple):
    """Point-query variant of :class:`ModeledOcclusionInputs`: the focused scene's
    triangle coefficients (ops/occlusion.SceneCoeffs) instead of a depth image."""

    coeffs: torch.Tensor  # (B, T, 12)
    tri_valid: torch.Tensor  # (B, T) bool
    corner_u: torch.Tensor  # (B,)
    corner_v: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,)
    body_visible: torch.Tensor  # (B,) bool
    image_size: int  # focused image side


class RegionCheckQueryInputs(NamedTuple):
    """Point-query variant of :class:`RegionCheckInputs` (region-id silhouette)."""

    coeffs: torch.Tensor  # (B, T, 12)
    tri_valid: torch.Tensor  # (B, T) bool
    sil_region_id: torch.Tensor  # (B, T) int32 per-triangle region ids
    corner_u: torch.Tensor  # (B,)
    corner_v: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,)
    region_id: torch.Tensor  # (B,) int32
    body_visible: torch.Tensor  # (B,) bool
    image_size: int  # focused image side


def _measured_occlusion_free(cfg: RegionConfig, center_f_body, depth_offset,
                             occ: MeasuredOcclusionInputs, width: int, height: int):
    """IsLineUnoccludedMeasured (region_modality.cpp:1343-1389) for (B, L, 3) line
    centers and (B, L) depth offsets -> (B, L) bool."""
    pose = occ.body2depth_camera_pose
    c = center_f_body @ pose[:, :3, :3].transpose(1, 2) + pose[:, None, :3, 3]
    z = c[..., 2]
    z_safe = torch.where(z > 0.0, z, torch.ones_like(z))
    cu = c[..., 0] * occ.fu / z_safe + occ.ppu
    cv = c[..., 1] * occ.fv / z_safe + occ.ppv

    meter_to_pixel = depth_fn.rdiv(occ.fu, z_safe)
    diameter = 2.0 * cfg.measured_occlusion_radius * meter_to_pixel
    min_depth = depth_fn.div_value(z - depth_offset - cfg.measured_occlusion_threshold,
                                   occ.depth_scale)

    if occ.presampled is not None:
        d, sample_ok = occ.presampled
    else:
        # region_modality.h:145 and depth_modality.h:113 agree on the stride count.
        n_strides = depth_fn.KMAX_N_OCCLUSION_STRIDES
        u_min, v_min, u_max, v_max, stride = depth_fn.window_bounds(
            diameter, n_strides, cu, cv, width, height)
        d, sample_ok, _, _ = depth_fn.window_samples(
            occ.depth_image, width, height, u_min, v_min, u_max, v_max, stride,
            n_strides + 1)
    return depth_fn.strided_window_min_free(d, sample_ok, min_depth)


def _trunc(x):
    return torch.trunc(x).to(torch.int32)


def _modeled_occlusion_grid(cfg: RegionConfig, center_u, center_v, depth, fu: float,
                            occ, image_size: int):
    """Sample grid of IsLineUnoccludedModeled (region_modality.cpp:1391-1431) for (B, L)
    lines: (uu (B, L, K), vv (B, L, K), sample_ok (B, L, K, K)), the (kv, ku) sample at
    focused pixel (vv[kv], uu[ku])."""
    z_safe = torch.where(depth > 0.0, depth, torch.ones_like(depth))
    meter_to_pixel = depth_fn.rdiv(fu, z_safe) * occ.scale[:, None]
    diameter = 2.0 * cfg.modeled_occlusion_radius * meter_to_pixel
    fcu = (center_u - occ.corner_u[:, None]) * occ.scale[:, None]
    fcv = (center_v - occ.corner_v[:, None]) * occ.scale[:, None]
    n_strides = depth_fn.KMAX_N_OCCLUSION_STRIDES
    u_min, v_min, u_max, v_max, stride = depth_fn.window_bounds(
        diameter, n_strides, fcu, fcv, image_size, image_size)
    _, sample_ok, uu, vv = depth_fn.window_samples(
        None, image_size, image_size, u_min, v_min, u_max, v_max, stride, n_strides + 1)
    return uu, vv, sample_ok


def _modeled_occlusion_from_min_depth(cfg: RegionConfig, depth, depth_offset, occ,
                                      min_depth):
    min_allowed = depth - depth_offset - cfg.modeled_occlusion_threshold
    return (min_depth > min_allowed) | ~occ.body_visible[:, None]


def modeled_occlusion_free(cfg: RegionConfig, center_u, center_v, depth, depth_offset,
                           fu: float, occ, image_size: int):
    """IsLineUnoccludedModeled (region_modality.cpp:1391-1431) for (B, L) lines -> (B, L)
    bool, from query or image inputs."""
    uu, vv, sample_ok = _modeled_occlusion_grid(cfg, center_u, center_v, depth, fu, occ,
                                                image_size)
    return _modeled_occlusion_from_min_depth(
        cfg, depth, depth_offset, occ, occlusion.window_min_depth(occ, uu, vv, sample_ok))


def _region_check_grid(cfg: RegionConfig, fscale: float, center_u, center_v, normal_u,
                       normal_v, chk, image_size: int):
    """Sample strides of IsDynamicLineRegionSufficient (cpp:1293-1341): (fg_u, fg_v, bg_u,
    bg_v (B, L, K) int32 clipped pixels, bg_inb (B, L, K) bool)."""
    focused_min_cd = cfg.min_continuous_distance * fscale * chk.scale        # (B,)
    focused_stride = torch.clamp(
        depth_fn.div_const(focused_min_cd - KREGION_OFFSET, KN_REGION_STRIDE), min=0.0)
    fcu = 0.5 + (center_u - chk.corner_u[:, None]) * chk.scale[:, None]
    fcv = 0.5 + (center_v - chk.corner_v[:, None]) * chk.scale[:, None]

    i = torch.arange(KN_REGION_STRIDE + 1, dtype=torch.float32, device=fcu.device)
    offset = (KREGION_OFFSET + i * focused_stride[:, None])[:, None, :]       # (B, 1, K)
    off_u = offset * normal_u[..., None]
    off_v = offset * normal_v[..., None]

    # Foreground side has no bounds check in the reference.
    fg_u = torch.clamp(_trunc(fcu[..., None] - off_u), 0, image_size - 1)
    fg_v = torch.clamp(_trunc(fcv[..., None] - off_v), 0, image_size - 1)

    # Background side: the walk stops where it leaves the image (running product).
    bu = fcu[..., None] + off_u
    bv = fcv[..., None] + off_v
    inb = (bu >= 0) & (bu < image_size) & (bv >= 0) & (bv < image_size)
    inb = torch.cumprod(inb.to(torch.int32), dim=-1).to(torch.bool)
    bg_u = torch.clamp(_trunc(bu), 0, image_size - 1)
    bg_v = torch.clamp(_trunc(bv), 0, image_size - 1)
    return fg_u, fg_v, bg_u, bg_v, inb


def _region_check_from_vals(chk, fg_vals, bg_vals, bg_inb):
    region_id = chk.region_id[:, None, None]
    fg_ok = (fg_vals == region_id).all(dim=-1)
    bg_ok = (~bg_inb | (bg_vals != region_id)).all(dim=-1)
    return (fg_ok & bg_ok) | ~chk.body_visible[:, None]


def region_check_ok(cfg: RegionConfig, fscale: float, center_u, center_v, normal_u,
                    normal_v, chk, image_size: int):
    """IsDynamicLineRegionSufficient (region_modality.cpp:1293-1341) for (B, L) lines ->
    (B, L) bool, from query or image inputs."""
    fg_u, fg_v, bg_u, bg_v, inb = _region_check_grid(
        cfg, fscale, center_u, center_v, normal_u, normal_v, chk, image_size)
    if isinstance(chk, RegionCheckQueryInputs):
        def sil_at(u_i, v_i):
            return occlusion.query_id(chk.coeffs, chk.tri_valid, chk.sil_region_id,
                                      u_i, v_i)
    else:
        body = torch.arange(fg_u.shape[0], device=fg_u.device)[:, None, None]

        def sil_at(u_i, v_i):
            return chk.silhouette[body, v_i.long(), u_i.long()]
    return _region_check_from_vals(chk, sil_at(fg_u, fg_v), sil_at(bg_u, bg_v), inb)


def combined_scene_checks(cfg: RegionConfig, fscale: float, center_u, center_v,
                          normal_u, normal_v, z, modeled_depth_offset, fu: float,
                          region_check: RegionCheckQueryInputs | None,
                          modeled_occlusion: ModeledOcclusionQueryInputs | None):
    """Region checking + modeled occlusion through ONE query evaluation.

    Both checks read the same focused scene (pipeline._scene_region_inputs), so their
    samples go to query_eval together: per line the 6x6 modeled-occlusion grid, then
    the 6 foreground and 6 background region strides.  Returns (region_ok (B, L) |
    None, modeled_free (B, L) | None), equal to region_check_ok and
    modeled_occlusion_free."""
    src = region_check if region_check is not None else modeled_occlusion
    image_size = src.image_size
    sil = (region_check.sil_region_id if region_check is not None
           else torch.zeros(src.tri_valid.shape, dtype=torch.int32,
                            device=src.tri_valid.device))

    qs_u, qs_v = [], []
    if modeled_occlusion is not None:
        uu, vv, sample_ok = _modeled_occlusion_grid(
            cfg, center_u, center_v, z, fu, modeled_occlusion, image_size)
        gu, gv = occlusion.window_pixels(uu, vv)
        kk = gu.shape[-1] * gu.shape[-2]
        qs_u.append(gu.flatten(-2))
        qs_v.append(gv.flatten(-2))
    if region_check is not None:
        fg_u, fg_v, bg_u, bg_v, bg_inb = _region_check_grid(
            cfg, fscale, center_u, center_v, normal_u, normal_v, region_check,
            image_size)
        qs_u += [fg_u, bg_u]
        qs_v += [fg_v, bg_v]

    u_all = torch.cat(qs_u, dim=-1)                                     # (B, L, 48) int32
    v_all = torch.cat(qs_v, dim=-1)
    inv_all, id_all = occlusion.query_eval(src.coeffs, src.tri_valid, sil, u_all, v_all)

    off = 0
    modeled_free = region_ok = None
    if modeled_occlusion is not None:
        inv = inv_all[..., :kk].reshape(sample_ok.shape)
        off = kk
        modeled_free = _modeled_occlusion_from_min_depth(
            cfg, z, modeled_depth_offset, modeled_occlusion,
            occlusion.window_min_depth_from_inv(inv, sample_ok))
    if region_check is not None:
        kr = fg_u.shape[-1]
        region_ok = _region_check_from_vals(region_check, id_all[..., off:off + kr],
                                            id_all[..., off + kr:off + 2 * kr], bg_inb)
    return region_ok, modeled_free


# ----------------------------------------------------------------------------------------
# The host path's per-modality functions (m3t_tpu/ops/region_fn.py:404-798), with the
# bodies as a leading batch dimension: a RegionModality calls them with B = 1.
# ----------------------------------------------------------------------------------------


class ViewPoints(NamedTuple):
    """Gathered model points of the closest view (RegionModel::DataPoint,
    region_model.h:89-95)."""

    center_f_body: torch.Tensor  # (B, L, 3)
    normal_f_body: torch.Tensor  # (B, L, 3)
    foreground_distance: torch.Tensor  # (B, L)
    background_distance: torch.Tensor  # (B, L)
    measured_depth_offset: torch.Tensor  # (B, L)
    modeled_depth_offset: torch.Tensor  # (B, L)


class DataLines(NamedTuple):
    """Per-line correspondence state (RegionModality::DataLine)."""

    center_f_body: torch.Tensor  # (B, L, 3)
    center_u: torch.Tensor  # (B, L)
    center_v: torch.Tensor  # (B, L)
    normal_u: torch.Tensor  # (B, L)
    normal_v: torch.Tensor  # (B, L)
    delta_r: torch.Tensor  # (B, L)
    normal_component_to_scale: torch.Tensor  # (B, L)
    distribution: torch.Tensor  # (B, L, D)
    mean: torch.Tensor  # (B, L)
    measured_variance: torch.Tensor  # (B, L)
    valid: torch.Tensor  # (B, L) bool


def _project_lines(points: ViewPoints, body2camera_pose, fu: float, fv: float, ppu: float,
                   ppv: float):
    """CalculateBasicLineData (cpp:1231-1250): (z, center_u, center_v, normal_u,
    normal_v), each (B, L)."""
    rot = body2camera_pose[:, :3, :3]
    center_cam = points.center_f_body @ rot.transpose(1, 2) + body2camera_pose[:, None, :3, 3]
    z = center_cam[..., 2]
    z_safe = torch.where(z > 0.0, z, torch.ones_like(z))
    center_u = center_cam[..., 0] * fu / z_safe + ppu
    center_v = center_cam[..., 1] * fv / z_safe + ppv
    normal_xy = points.normal_f_body @ rot[:, :2].transpose(1, 2)  # body2camera_rotation_xy_
    norm = torch.sqrt(torch.sum(normal_xy * normal_xy, dim=-1))
    normal_xy = normal_xy / torch.where(norm > 0.0, norm, torch.ones_like(norm))[..., None]
    return z, center_u, center_v, normal_xy[..., 0], normal_xy[..., 1]


def _line_index_ok(n_lines, count: int, device):
    """(B or 1, count) bool: line index < n_lines (a Python int or a (B,) tensor)."""
    idx = torch.arange(count, device=device)[None, :]
    if isinstance(n_lines, torch.Tensor):
        return idx < n_lines.to(device)[:, None]
    return idx < n_lines


def _per_body(flag, n_bodies: int, device):
    """A bool, or a (B,) or (1,) bool tensor, as a (B,) bool tensor on device; a bool is
    filled on the device (a graph's capture cannot copy one from the host)."""
    if isinstance(flag, torch.Tensor):
        return flag.to(device=device, dtype=torch.bool).expand(n_bodies)
    return torch.full((n_bodies,), bool(flag), dtype=torch.bool, device=device)


def _focused_size(inputs) -> int:
    """The focused image side of query inputs, or of the image of image inputs."""
    if hasattr(inputs, "image_size"):
        return inputs.image_size
    return inputs[0].shape[-1]


def _image_bounds(i_cu, i_cv, width: int, height: int):
    return (i_cu >= 0) & (i_cu <= width - 1) & (i_cv >= 0) & (i_cv <= height - 1)


def calculate_correspondences(
    cfg: RegionConfig,
    scale: int,
    points: ViewPoints,
    n_lines,
    body2camera_pose,
    color_image,
    hist_f,
    hist_b,
    fu: float, fv: float, ppu: float, ppv: float, width: int, height: int,
    handle_occlusions,
    measured_occlusion: MeasuredOcclusionInputs | None = None,
    modeled_occlusion=None,
    region_check=None,
    function_lookup_f=None,
    function_lookup_b=None,
) -> DataLines:
    """One correspondence pass (reference: CalculateCorrespondences, cpp:390-465).

    body2camera_pose (B, 4, 4); color_image (B, H, W, 3) uint8; hist_f, hist_b (B, N);
    handle_occlusions a bool or (B,) bool; n_lines a Python int or a (B,) tensor.
    modeled_occlusion and region_check take the image or the query inputs.  Without
    lookups the host's ``cfg.function_lookups()`` are copied to the device, which a
    graph's capture refuses: a graphed caller passes device lookups."""
    n_bodies, n_max = points.center_f_body.shape[:2]
    s_seg = cfg.line_length_in_segments
    d_len = cfg.distribution_length
    f_len = cfg.function_length
    line_length = s_seg * scale
    fscale = float(scale)
    ll_minus_1 = line_length - 1
    ll_minus_1_half = (line_length - 1) * 0.5
    ll_half_minus_1 = line_length * 0.5 - 1.0

    z, center_u, center_v, normal_u, normal_v = _project_lines(
        points, body2camera_pose, fu, fv, ppu, ppv)
    dev = z.device
    ones = torch.ones_like(z)
    if function_lookup_f is None:
        function_lookup_f, function_lookup_b = cfg.function_lookups()
    lookup_f = torch.as_tensor(function_lookup_f, device=dev)
    lookup_b = torch.as_tensor(function_lookup_b, device=dev)

    # --- IsLineValid (cpp:1252-1291) --------------------------------------------------
    continuous_distance = (
        torch.minimum(points.background_distance, points.foreground_distance)
        * fu / (torch.where(z > 0, z, ones) * fscale))
    valid = _line_index_ok(n_lines, n_max, dev)
    valid = valid & (continuous_distance >= cfg.min_continuous_distance)
    valid = valid & (z > 0.0)
    valid = valid & _image_bounds(_trunc(center_u + 0.5), _trunc(center_v + 0.5), width,
                                  height)
    if region_check is not None:
        valid = valid & region_check_ok(cfg, fscale, center_u, center_v, normal_u,
                                        normal_v, region_check, _focused_size(region_check))

    occl_ok = torch.ones_like(valid)
    if measured_occlusion is not None:
        depth_image = measured_occlusion.depth_image
        occl_ok = occl_ok & _measured_occlusion_free(
            cfg, points.center_f_body, points.measured_depth_offset, measured_occlusion,
            depth_image.shape[2], depth_image.shape[1])
    if modeled_occlusion is not None:
        occl_ok = occl_ok & modeled_occlusion_free(
            cfg, center_u, center_v, z, points.modeled_depth_offset, fu, modeled_occlusion,
            _focused_size(modeled_occlusion))

    # --- CalculateSegmentProbabilities (cpp:1433-1573) --------------------------------
    is_u_dom = torch.abs(normal_v) < torch.abs(normal_u)
    normal_p = torch.where(is_u_dom, normal_u, normal_v)  # dominant-axis component
    normal_s = torch.where(is_u_dom, normal_v, normal_u)
    center_p = torch.where(is_u_dom, center_u, center_v)
    center_s = torch.where(is_u_dom, center_v, center_u)
    size_p = torch.where(is_u_dom, width, height)
    size_s = torch.where(is_u_dom, height, width)
    # Degenerate contour normals (projected to ~zero) cannot define a line direction.
    normal_ok = torch.abs(normal_p) > 0.0
    valid = valid & normal_ok
    safe_normal_p = torch.where(normal_ok, normal_p, ones)
    step = normal_s / safe_normal_p

    p0 = _trunc(center_p - ll_half_minus_1)
    p_end = p0 + ll_minus_1
    s_f0 = center_s + step * (p0.to(torch.float32) - center_p) + 0.5
    s_f_end = s_f0 + step * float(ll_minus_1)
    t0, t_end = _trunc(s_f0), _trunc(s_f_end)
    valid = valid & ((p0 >= 0) & (p_end <= size_p - 1) & (t0 >= 0) & (t0 <= size_s - 1)
                     & (t_end >= 1) & (t_end <= size_s - 2))

    k = torch.arange(line_length, dtype=torch.int32, device=dev)
    p_k = p0[..., None] + k
    s_k = _trunc(s_f0[..., None] + k.to(torch.float32) * step[..., None])
    u_k = torch.clamp(torch.where(is_u_dom[..., None], p_k, s_k), 0, width - 1)
    v_k = torch.clamp(torch.where(is_u_dom[..., None], s_k, p_k), 0, height - 1)
    body = torch.arange(n_bodies, device=dev)[:, None, None]
    pixels = color_image[body, v_k.long(), u_k.long()]  # (B, L, LL, 3)
    pf, pb = hist_ops.lookup_probabilities(hist_f, hist_b, pixels, cfg.n_histogram_bins)

    # Per-segment products: forward lines fill segment k // scale, reverse lines fill
    # S - 1 - k // scale (cpp:1458-1489): computed forward, then flipped where needed.
    seg_f = torch.prod(pf.reshape(n_bodies, n_max, s_seg, scale), dim=-1)
    seg_b = torch.prod(pb.reshape(n_bodies, n_max, s_seg, scale), dim=-1)
    forward = (normal_p > 0)[..., None]
    seg_f = torch.where(forward, seg_f, seg_f.flip(-1))
    seg_b = torch.where(forward, seg_b, seg_b.flip(-1))
    if scale > 1:
        total = seg_f + seg_b
        nz = total > 0.0
        safe = torch.where(nz, total, torch.ones_like(total))
        half = torch.full_like(total, 0.5)
        seg_f = torch.where(nz, seg_f / safe, half)
        seg_b = torch.where(nz, seg_b / safe, half)

    normal_component_to_scale = depth_fn.div_const(torch.abs(normal_p), fscale)
    delta_r = (torch.floor(center_p - ll_minus_1_half + 0.5) + ll_minus_1_half
               - center_p) / safe_normal_p

    # --- CalculateDistribution (cpp:1600-1637) ----------------------------------------
    # dist[d] = prod_i seg_f[d+i]*lf[i] + seg_b[d+i]*lb[i]
    d_idx = (torch.arange(d_len, device=dev)[:, None]
             + torch.arange(f_len, device=dev)[None, :])  # (D, F)
    mixed = seg_f[..., d_idx] * lookup_f + seg_b[..., d_idx] * lookup_b
    distribution = torch.prod(mixed, dim=-1)  # (B, L, D)
    area = torch.sum(distribution, dim=-1, keepdim=True)
    distribution = distribution / torch.where(area > 0.0, area, torch.ones_like(area))

    # --- CalculateDistributionMoments (cpp:1639-1658) ---------------------------------
    idx = torch.arange(d_len, dtype=torch.float32, device=dev)
    mean_from_begin = torch.sum(idx * distribution, dim=-1)
    var = torch.sum((idx - mean_from_begin[..., None]) ** 2 * distribution, dim=-1)
    mean = mean_from_begin - (d_len - 1) / 2.0
    measured_variance = torch.clamp(var, min=cfg.min_expected_variance)

    # --- two-pass occlusion fallback (cpp:435-463) ------------------------------------
    valid_with = valid & occl_ok
    use_occlusions = (_per_body(handle_occlusions, n_bodies, dev)
                      & (valid_with.sum(dim=-1) >= cfg.min_n_unoccluded_lines))
    final_valid = torch.where(use_occlusions[:, None], valid_with, valid)

    return DataLines(
        center_f_body=points.center_f_body, center_u=center_u, center_v=center_v,
        normal_u=normal_u, normal_v=normal_v, delta_r=delta_r,
        normal_component_to_scale=normal_component_to_scale, distribution=distribution,
        mean=mean, measured_variance=measured_variance, valid=final_valid)


def calculate_gradient_and_hessian(cfg: RegionConfig, lines: DataLines, body2camera_pose,
                                   fu: float, fv: float, ppu: float, ppv: float,
                                   standard_deviation: float, global_iteration: bool):
    """Newton gradient (B, 6) and Hessian (B, 6, 6) in the body frame (reference:
    cpp:485-558).  ``global_iteration`` selects the mean/variance form over the local
    log-likelihood finite difference."""
    d_len = cfg.distribution_length
    rot = body2camera_pose[:, :3, :3]
    variance = standard_deviation ** 2

    c = lines.center_f_body @ rot.transpose(1, 2) + body2camera_pose[:, None, :3, 3]
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    z_safe = torch.where(z != 0, z, torch.ones_like(z))
    fu_z = depth_fn.rdiv(fu, z_safe)
    fv_z = depth_fn.rdiv(fv, z_safe)
    xfu_z = x * fu_z
    yfv_z = y * fv_z
    delta_cs = (lines.normal_u * (xfu_z + ppu - lines.center_u)
                + lines.normal_v * (yfv_z + ppv - lines.center_v)
                - lines.delta_r) * lines.normal_component_to_scale

    if global_iteration:
        dll = (lines.mean - delta_cs) / lines.measured_variance
        valid = lines.valid
    else:
        dist_idx_upper = _trunc(delta_cs + (d_len + 1) / 2.0)
        dist_idx_lower = dist_idx_upper - 1
        in_range = (dist_idx_upper > 0) & (dist_idx_upper < d_len)
        iu = torch.clamp(dist_idx_upper, 0, d_len - 1).long()
        il = torch.clamp(dist_idx_lower, 0, d_len - 1).long()
        p_u = torch.gather(lines.distribution, -1, iu[..., None])[..., 0]
        p_l = torch.gather(lines.distribution, -1, il[..., None])[..., 0]
        dll = ((torch.log(torch.clamp(p_u, min=1e-30)) - torch.log(torch.clamp(p_l, min=1e-30)))
               * cfg.learning_rate / lines.measured_variance)
        valid = lines.valid & in_range

    nts = lines.normal_component_to_scale
    dcenter = torch.stack([
        nts * lines.normal_u * fu_z,
        nts * lines.normal_v * fv_z,
        nts * (-lines.normal_u * xfu_z - lines.normal_v * yfv_z) / z_safe,
    ], dim=-1)  # (B, L, 3)
    dtrans = dcenter @ rot  # row vector times the body2camera rotation (cpp:537)
    dtheta = torch.cat([torch.linalg.cross(lines.center_f_body, dtrans, dim=-1), dtrans],
                       dim=-1)  # (B, L, 6)

    weight = depth_fn.rdiv(cfg.min_expected_variance, nts * nts * variance)
    wmask = torch.where(valid, weight, torch.zeros_like(weight))
    gradient = torch.sum((wmask * dll)[..., None] * dtheta, dim=1)
    hessian = -((dtheta * (wmask / lines.measured_variance)[..., None]).transpose(1, 2)
                @ dtheta)
    return gradient, hessian


def add_line_pixel_colors(
    cfg: RegionConfig,
    points: ViewPoints,
    n_lines,
    body2camera_pose,
    color_image,
    memory_f,
    memory_b,
    fu: float, fv: float, ppu: float, ppv: float, width: int, height: int,
    handle_occlusions,
    measured_occlusion: MeasuredOcclusionInputs | None = None,
    modeled_occlusion=None,
    region_check: RegionCheckInputs | None = None,
):
    """Foreground and background pixel colours along the contour normals added to the
    histogram memories (B, N) (reference: AddLinePixelColorsToTempHistograms,
    cpp:1025-1155).  Returns (memory_f, memory_b)."""
    n_bodies, n_max = points.center_f_body.shape[:2]
    max_steps = int(np.ceil(cfg.max_considered_line_length)) + 1

    z, center_u, center_v, normal_u, normal_v = _project_lines(
        points, body2camera_pose, fu, fv, ppu, ppv)
    dev = z.device
    ones = torch.ones_like(z)
    valid = _line_index_ok(n_lines, n_max, dev) & (z > 0.0)
    valid = valid & _image_bounds(_trunc(center_u + 0.5), _trunc(center_v + 0.5), width,
                                  height)
    ignore_occlusions = ~_per_body(handle_occlusions, n_bodies, dev)[:, None]
    if measured_occlusion is not None:
        depth_image = measured_occlusion.depth_image
        valid = valid & (_measured_occlusion_free(
            cfg, points.center_f_body, points.measured_depth_offset, measured_occlusion,
            depth_image.shape[2], depth_image.shape[1]) | ignore_occlusions)
    if modeled_occlusion is not None:
        valid = valid & (modeled_occlusion_free(
            cfg, center_u, center_v, z, points.modeled_depth_offset, fu, modeled_occlusion,
            _focused_size(modeled_occlusion)) | ignore_occlusions)

    length_f = torch.full_like(z, cfg.max_considered_line_length)
    length_b = torch.full_like(z, cfg.max_considered_line_length)
    if region_check is not None:
        length_f, length_b = dynamic_region_distance(
            cfg, center_u, center_v, normal_u, normal_v, region_check,
            region_check.silhouette.shape[-1])

    z_safe = torch.where(z > 0, z, ones)
    l_f = points.foreground_distance * fu / z_safe
    l_b = points.background_distance * fu / z_safe
    length_f = torch.minimum(length_f, l_f - 2.0 * cfg.unconsidered_line_length)
    length_b = torch.minimum(length_b, l_b - 2.0 * cfg.unconsidered_line_length)

    abs_nu = torch.abs(normal_u)
    abs_nv = torch.abs(normal_v)
    u_dom = abs_nu > abs_nv
    u_step = torch.where(u_dom, torch.sign(normal_u),
                         normal_u / torch.where(abs_nv > 0, abs_nv, ones))
    v_step = torch.where(u_dom, normal_v / torch.where(abs_nu > 0, abs_nu, ones),
                         torch.sign(normal_v))
    dom = torch.where(u_dom, abs_nu, abs_nv)
    proj_len_f = _trunc(length_f * dom + 0.5)
    proj_len_b = _trunc(length_b * dom + 0.5)

    k = torch.arange(max_steps, dtype=torch.float32, device=dev)
    body = torch.arange(n_bodies, device=dev)[:, None, None]

    def collect(sign, proj_len):
        u0 = center_u + sign * normal_u * cfg.unconsidered_line_length + 0.5
        v0 = center_v + sign * normal_v * cfg.unconsidered_line_length + 0.5
        iu = _trunc(u0[..., None] + sign * k * u_step[..., None])
        iv = _trunc(v0[..., None] + sign * k * v_step[..., None])
        inb = _image_bounds(iu, iv, width, height)
        inb = torch.cumprod(inb.to(torch.int32), dim=-1).to(torch.bool)  # break on OOB
        mask = inb & (torch.arange(max_steps, device=dev) < proj_len[..., None]) \
            & valid[..., None]
        iu = torch.clamp(iu, 0, width - 1).long()
        iv = torch.clamp(iv, 0, height - 1).long()
        return color_image[body, iv, iu], mask

    fg_px, fg_mask = collect(-1.0, proj_len_f)
    bg_px, bg_mask = collect(1.0, proj_len_b)
    memory_f = hist_ops.add_colors(memory_f, fg_px, fg_mask, cfg.n_histogram_bins)
    memory_b = hist_ops.add_colors(memory_b, bg_px, bg_mask, cfg.n_histogram_bins)
    return memory_f, memory_b


def dynamic_region_distance(cfg: RegionConfig, center_u, center_v, normal_u, normal_v,
                            chk: RegionCheckInputs, image_size: int):
    """DynamicRegionDistance (region_modality.cpp:1157-1229) for (B, L) lines:
    (foreground, background) line lengths (B, L).

    The reference's background search writes the foreground distance (cpp:1223, an
    apparent copy-paste slip); like the JAX package, this limits the background
    distance, the documented intent (PARITY.md, "Adjudicated deviations" 1)."""
    dev = center_u.device
    max_len = cfg.max_considered_line_length
    stride = max_len / KN_REGION_STRIDE
    scale = chk.scale[:, None, None]                                        # (B, 1, 1)
    focused_stride = stride * scale
    delta_start = depth_fn.rdiv(KREGION_OFFSET, chk.scale) - cfg.unconsidered_line_length
    i_start = torch.clamp(_trunc(depth_fn.div_const(delta_start, stride) + 1.0), min=0)
    i_start_f = i_start.to(torch.float32)[:, None, None]

    offset = cfg.unconsidered_line_length + i_start_f * stride
    focused_offset = offset * scale
    fcu = 0.5 + (center_u - chk.corner_u[:, None]) * chk.scale[:, None]
    fcv = 0.5 + (center_v - chk.corner_v[:, None]) * chk.scale[:, None]

    i = torch.arange(KN_REGION_STRIDE + 1, dtype=torch.float32, device=dev)
    active = i >= i_start_f                                                 # (B, 1, K)
    along = focused_offset + (i - i_start_f) * focused_stride               # (B, 1, K)
    du = along * normal_u[..., None]
    dv = along * normal_v[..., None]
    body = torch.arange(center_u.shape[0], device=dev)[:, None, None]
    region_id = chk.region_id[:, None, None]

    def first_break(u, v, want_equal):
        oob = (u >= image_size) | (u < 0) | (v >= image_size) | (v < 0)
        iu = torch.clamp(_trunc(u), 0, image_size - 1).long()
        iv = torch.clamp(_trunc(v), 0, image_size - 1).long()
        vals = chk.silhouette[body, iv, iu]
        hit = (vals == region_id) if want_equal else (vals != region_id)
        stop_oob = oob & active
        stop_hit = hit & active & ~oob
        # The first stop of either kind; the two kinds give different distances.
        any_stop = stop_oob | stop_hit
        first = torch.argmax(any_stop.to(torch.int32), dim=-1)
        stopped_oob = torch.gather(stop_oob, -1, first[..., None])[..., 0]
        return any_stop.any(dim=-1), first, stopped_oob

    full = torch.full_like(center_u, max_len)
    # Foreground: walk inward; stop where the pixel leaves the region (or the image).
    has_f, first_f, oob_f = first_break(fcu[..., None] - du, fcv[..., None] - dv, False)
    stop_f = stride * first_f.to(torch.float32)
    hit_f = torch.where(first_f == i_start[:, None], torch.zeros_like(stop_f), stop_f)
    dist_f = torch.where(has_f, torch.where(oob_f, stop_f, hit_f), full)
    # Background: walk outward; stop where the pixel enters the region again (or leaves
    # the image).
    has_b, first_b, oob_b = first_break(fcu[..., None] + du, fcv[..., None] + dv, True)
    stop_b = stride * first_b.to(torch.float32)
    hit_b = torch.where(first_b == i_start[:, None], torch.zeros_like(stop_b), stop_b)
    dist_b = torch.where(has_b, torch.where(oob_b, full, hit_b), full)
    visible = chk.body_visible[:, None]
    return torch.where(visible, dist_f, full), torch.where(visible, dist_b, full)
