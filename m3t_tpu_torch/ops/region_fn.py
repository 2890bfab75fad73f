"""Region-modality configuration, occlusions and region checking (port of
m3t_tpu/ops/region_fn.py:27-71, 102-162, 183-401).

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
    min_depth = (z - depth_offset - cfg.measured_occlusion_threshold) / occ.depth_scale

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
    focused_stride = torch.clamp((focused_min_cd - KREGION_OFFSET) / KN_REGION_STRIDE,
                                 min=0.0)
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
