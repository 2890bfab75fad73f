"""Depth-modality correspondences and Gauss-Newton terms on PyTorch (port of
m3t_tpu/ops/depth_fn.py).

ICP-style point-to-plane correspondences on a depth image: per model point, a strided
(K, K) window around the projection is searched for the nearest valid 3D point
(FindCorrespondence, depth_modality.cpp:826-884).  The JAX module works on one body and
is ``vmap``-ed by its pipeline; here the batch of bodies is a leading dimension:
  model points   (B, P, 3)
  windows        (B, P, Kv, Ku)
  depth images   (B, H, W) uint16

Numerics: every expression keeps the JAX source's operation order.  A Python number
divided by a tensor goes through :func:`rdiv`, which rounds once as JAX does
(``Tensor.__rtruediv__`` multiplies by the reciprocal), so window positions, which are
``trunc`` of such quotients, agree exactly.  A division by a Python number whose quotient
reaches a trunc or a comparison goes through :func:`div_const` where the JAX function
holds it as a constant and :func:`div_value` where JAX traces it; these helpers are
shared by the region functions and the pipeline.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from m3t_tpu_torch import graphs

KMAX_N_OCCLUSION_STRIDES = 5  # depth_modality.h:113


class DepthConfig(NamedTuple):
    """Static configuration (defaults: depth_modality.h:302-321)."""

    n_points_max: int = 200
    use_depth_scaling: bool = False
    stride_length: float = 0.005
    measured_occlusion_radius: float = 0.01
    measured_occlusion_threshold: float = 0.03
    modeled_occlusion_radius: float = 0.01
    modeled_occlusion_threshold: float = 0.03
    min_n_unoccluded_points: int = 0


class DepthViewPoints(NamedTuple):
    center_f_body: torch.Tensor  # (B, P, 3)
    normal_f_body: torch.Tensor  # (B, P, 3)
    measured_depth_offset: torch.Tensor  # (B, P)
    modeled_depth_offset: torch.Tensor  # (B, P)


class DepthDataPoints(NamedTuple):
    center_f_body: torch.Tensor  # (B, P, 3)
    normal_f_body: torch.Tensor  # (B, P, 3)
    correspondence_center_f_camera: torch.Tensor  # (B, P, 3)
    valid: torch.Tensor  # (B, P) bool


class DepthModeledOcclusionInputs(NamedTuple):
    """Rendered focused depth crops for the modeled-occlusion check (image mode)."""

    focused_depth: torch.Tensor  # (B, S, S) float32 meters
    corner_u: torch.Tensor  # (B,)
    corner_v: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,)
    body_visible: torch.Tensor  # (B,) bool


class SilhouetteCheckInputs(NamedTuple):
    """Rendered focused body-id crops for the silhouette check (image mode)."""

    silhouette: torch.Tensor  # (B, S, S) int32 body ids
    corner_u: torch.Tensor  # (B,)
    corner_v: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,)
    body_id: torch.Tensor  # (B,) int32
    body_visible: torch.Tensor  # (B,) bool


class DepthModeledOcclusionQueryInputs(NamedTuple):
    """Point-query variant of :class:`DepthModeledOcclusionInputs` (SceneCoeffs)."""

    coeffs: torch.Tensor  # (B, T, 12)
    tri_valid: torch.Tensor  # (B, T) bool
    corner_u: torch.Tensor  # (B,)
    corner_v: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,)
    body_visible: torch.Tensor  # (B,) bool
    image_size: int  # focused image side


class SilhouetteCheckQueryInputs(NamedTuple):
    """Point-query variant of :class:`SilhouetteCheckInputs` (body-id silhouette)."""

    coeffs: torch.Tensor  # (B, T, 12)
    tri_valid: torch.Tensor  # (B, T) bool
    sil_body_id: torch.Tensor  # (B, T) int32 per-triangle body ids
    corner_u: torch.Tensor  # (B,)
    corner_v: torch.Tensor  # (B,)
    scale: torch.Tensor  # (B,)
    body_id: torch.Tensor  # (B,) int32
    body_visible: torch.Tensor  # (B,) bool
    image_size: int  # focused image side


def _trunc(x):
    return torch.trunc(x).to(torch.int32)


def rdiv(a: float, x):
    """``a / x`` for a Python number ``a``, rounded once (as JAX divides)."""
    return torch.div(torch.tensor(a, dtype=x.dtype), x)


def div_const(x, n: float):
    """``x / n`` for a Python number ``n`` as jitted JAX computes it where ``n`` is a
    constant of the jitted function (a literal or a static config field): XLA rewrites a
    division by a constant as a product with the constant's float32 reciprocal.  The
    two differ by an ulp, which decides a trunc that lands on an integer: with depth
    scaling the window diameter 2 * considered_distance * fu is z-free, and at fu = 600
    the 0.05 m scale's 60 px over 6 strides truncates 10 + 1 to 10 or 11 by the last bit
    of z * (fu / z), where the product gives 11 for every z.  (A plain ``x / n`` divides
    on the CPU and, on CUDA, multiplies by 1 / n taken in double and rounded to float32,
    which can differ where n is not a float32 value.)"""
    return x * float(np.float32(1.0) / np.float32(n))


@functools.lru_cache(maxsize=256)
def _device_scalar(c: float, dtype, device):
    if graphs.capturing():
        # A graph's capture follows its warm-up, which made every scalar it divides by;
        # one made here would be filled only when the graph replays.
        raise RuntimeError(f"div_value: the divisor {c} was not made before the capture")
    return torch.full((), c, dtype=dtype, device=device)


def div_value(x, c: float):
    """``x / c`` for a Python number ``c`` rounded once on every device, as JAX divides
    by a value it traces (the intrinsics, the depth scale): PyTorch on CUDA multiplies
    by the reciprocal of a Python-number divisor, one rounding more, but divides by a
    divisor on the device, which is made once per (value, dtype, device).  A graph
    that reads the divisor holds it (graphs.hold), so that the cache cannot free it."""
    divisor = _device_scalar(float(c), x.dtype, x.device)
    graphs.hold(divisor)
    return x / divisor


def gather_u16(images, body, rows, cols):
    """``images[body, rows, cols]`` of (B, H, W) uint16 images as int32.

    The gather reads the int16 view of the image and masks the sign extension off,
    because int16 indexing and int32 arithmetic exist on every device."""
    return images.view(torch.int16)[body, rows, cols].to(torch.int32) & 0xFFFF


def strided_window_min_free(depth_values, sample_ok, min_depth):
    """(B, P) bool: no sample of the (B, P, K, K) window lies in (0, min_depth)."""
    occluding = sample_ok & (depth_values > 0) & (depth_values < min_depth[..., None, None])
    return ~occluding.flatten(-2).any(dim=-1)


def window_samples(image, width: int, height: int, u_min, v_min, u_max, v_max, stride,
                   n_samples: int):
    """Direct gather of the strided windows from the full images (B, H, W).

    Returns (d (B, P, Kv, Ku) f32 raw depth, sample_ok (B, P, Kv, Ku) bool, uu (B, P, K),
    vv (B, P, K)) with the (kv, ku) sample at pixel (vv[kv], uu[ku])."""
    k = torch.arange(n_samples, dtype=torch.int32, device=u_min.device)
    us = u_min[..., None] + k * stride[..., None]                  # (B, P, K)
    vs = v_min[..., None] + k * stride[..., None]
    u_ok = us <= u_max[..., None]
    v_ok = vs <= v_max[..., None]
    uu = torch.clamp(us, 0, width - 1)
    vv = torch.clamp(vs, 0, height - 1)
    sample_ok = v_ok[..., :, None] & u_ok[..., None, :]
    d = None
    if image is not None:
        body = torch.arange(u_min.shape[0], device=u_min.device)[:, None, None, None]
        d = gather_u16(image, body, vv[..., :, None].long(),
                       uu[..., None, :].long()).to(torch.float32)
    return d, sample_ok, uu, vv


def measured_occlusion_window(radius: float, use_depth_scaling: bool, z_safe, cu, cv,
                              fu: float, width: int, height: int):
    """Window geometry of IsPointUnoccludedMeasured (depth_modality.cpp:736-776):
    (u_min, v_min, u_max, v_max, stride), each (B, P) int32."""
    diameter = 2.0 * radius * fu
    if use_depth_scaling:
        diameter = torch.full_like(z_safe, diameter)
    else:
        diameter = rdiv(diameter, z_safe)
    return window_bounds(diameter, KMAX_N_OCCLUSION_STRIDES, cu, cv, width, height)


def window_start(diameter, max_n_strides: int, cu, cv):
    """Unclamped window corner, rounded diameter and stride (each (B, P) int32) of a
    strided window of ``diameter`` pixels around (cu, cv)."""
    stride = _trunc(div_const(diameter, max_n_strides) + 1.0)
    n_strides = _trunc(diameter / stride.to(torch.float32) + 0.5)
    rounded_diameter = n_strides * stride
    rounded_radius = 0.5 * rounded_diameter.to(torch.float32)
    u_min0 = _trunc(cu - rounded_radius + 0.5)
    v_min0 = _trunc(cv - rounded_radius + 0.5)
    return u_min0, v_min0, rounded_diameter, stride


def window_bounds(diameter, max_n_strides: int, cu, cv, width: int, height: int):
    u_min0, v_min0, rounded_diameter, stride = window_start(diameter, max_n_strides,
                                                            cu, cv)
    u_max = torch.clamp(u_min0 + rounded_diameter, max=width - 1)
    v_max = torch.clamp(v_min0 + rounded_diameter, max=height - 1)
    u_min = torch.clamp(u_min0, min=0)
    v_min = torch.clamp(v_min0, min=0)
    return u_min, v_min, u_max, v_max, stride


def max_n_strides(cfg: DepthConfig, considered_distance: float) -> int:
    return max(int(considered_distance / cfg.stride_length + 0.5), 1)


def correspondence_diameter(cfg: DepthConfig, considered_distance: float, z, z_safe,
                            fu: float):
    """(cd, diameter) of FindCorrespondence's search window, each (B, P) f32."""
    if cfg.use_depth_scaling:
        cd = considered_distance * z
    else:
        cd = torch.full_like(z, considered_distance)
    meter_to_pixel = rdiv(fu, z_safe)
    return cd, 2.0 * cd * meter_to_pixel


def project_points(centers, pose, fu: float, fv: float, ppu: float, ppv: float):
    """Camera-frame points and projections of (B, P, 3) body-frame points:
    (c (B, P, 3), z, z_safe, cu, cv)."""
    c = centers @ pose[:, :3, :3].transpose(1, 2) + pose[:, None, :3, 3]
    z = c[..., 2]
    z_safe = torch.where(z > 0, z, torch.ones_like(z))
    cu = c[..., 0] * fu / z_safe + ppu
    cv = c[..., 1] * fv / z_safe + ppv
    return c, z, z_safe, cu, cv


def calculate_correspondences(
    cfg: DepthConfig,
    considered_distance: float,
    points: DepthViewPoints,
    n_points,
    body2camera_pose,
    depth_image,
    fu: float, fv: float, ppu: float, ppv: float, width: int, height: int,
    depth_scale: float,
    handle_occlusions,
    measure_occlusions: bool = False,
    modeled_occlusion=None,
    silhouette_check=None,
    presampled=None,
    measured_presampled=None,
) -> DepthDataPoints:
    """One correspondence pass for a batch (reference: CalculateCorrespondences,
    cpp:252-315).

    body2camera_pose (B, 4, 4); depth_image (B, H, W) uint16 (may be None when both
    window sets come presampled); handle_occlusions (B,) bool; n_points a Python int or
    a (B,) tensor.  modeled_occlusion: DepthModeledOcclusion[Query]Inputs and
    silhouette_check: SilhouetteCheck[Query]Inputs of the focused scene, or None.
    presampled: optional (d (B, P, K, K) f32 raw depth, in_crop (B, P, K, K) bool) from
    ops/depth_fast.presample_windows; measured_presampled: optional (d, ok) from
    ops/depth_fast.presample_occlusion_windows.
    """
    from m3t_tpu_torch.ops import occlusion

    dev = body2camera_pose.device
    n_bodies, n_pts = points.center_f_body.shape[:2]
    k_max = max_n_strides(cfg, considered_distance)

    c, z, z_safe, cu, cv = project_points(points.center_f_body, body2camera_pose,
                                          fu, fv, ppu, ppv)
    index = torch.arange(n_pts, device=dev)[None, :]
    if isinstance(n_points, torch.Tensor):
        valid = index < n_points[:, None]
    else:
        valid = (index < n_points).expand(n_bodies, n_pts)
    valid = valid & (z > 0.0)
    i_cu = _trunc(cu + 0.5)
    i_cv = _trunc(cv + 0.5)
    valid = valid & (i_cu >= 0) & (i_cu <= width - 1) & (i_cv >= 0) & (i_cv <= height - 1)

    # Silhouette check (IsPointOnValidSilhouette, cpp:728-734): the body-id silhouette
    # of the focused scene, sampled at the point's focused pixel.
    if silhouette_check is not None:
        s = silhouette_check
        query = isinstance(s, SilhouetteCheckQueryInputs)
        size = s.image_size if query else s.silhouette.shape[-1]
        fu_c = _trunc((cu - s.corner_u[:, None]) * s.scale[:, None] + 0.5)
        fv_c = _trunc((cv - s.corner_v[:, None]) * s.scale[:, None] + 0.5)
        inb = (fu_c >= 0) & (fu_c < size) & (fv_c >= 0) & (fv_c < size)
        su = torch.clamp(fu_c, 0, size - 1)
        sv = torch.clamp(fv_c, 0, size - 1)
        if query:
            vals = occlusion.query_id(s.coeffs, s.tri_valid, s.sil_body_id, su, sv)
        else:
            body = torch.arange(n_bodies, device=dev)[:, None]
            vals = s.silhouette[body, sv.long(), su.long()]
        ok = inb & (vals == s.body_id[:, None])
        valid = valid & (ok | ~s.body_visible[:, None])

    occl_ok = torch.ones_like(valid)
    if measure_occlusions:
        # IsPointUnoccludedMeasured (cpp:736-776)
        threshold = cfg.measured_occlusion_threshold
        if cfg.use_depth_scaling:
            threshold = threshold * z
        min_depth = div_value(z - points.measured_depth_offset - threshold, depth_scale)
        if measured_presampled is not None:
            d, sample_ok = measured_presampled
        else:
            u_min, v_min, u_max, v_max, stride = measured_occlusion_window(
                cfg.measured_occlusion_radius, cfg.use_depth_scaling, z_safe, cu, cv, fu,
                width, height)
            d, sample_ok, _, _ = window_samples(
                depth_image, width, height, u_min, v_min, u_max, v_max, stride,
                KMAX_N_OCCLUSION_STRIDES + 1)
        occl_ok = occl_ok & strided_window_min_free(d, sample_ok, min_depth)

    if modeled_occlusion is not None:
        # IsPointUnoccludedModeled (cpp:778-824)
        occ = modeled_occlusion
        size = (occ.image_size if isinstance(occ, DepthModeledOcclusionQueryInputs)
                else occ.focused_depth.shape[-1])
        meter_to_pixel = fu * occ.scale[:, None]
        if cfg.use_depth_scaling:
            meter_to_pixel = meter_to_pixel.expand(z_safe.shape)
        else:
            meter_to_pixel = meter_to_pixel / z_safe
        diameter = 2.0 * cfg.modeled_occlusion_radius * meter_to_pixel
        fcu = (cu - occ.corner_u[:, None]) * occ.scale[:, None]
        fcv = (cv - occ.corner_v[:, None]) * occ.scale[:, None]
        u_min, v_min, u_max, v_max, stride = window_bounds(
            diameter, KMAX_N_OCCLUSION_STRIDES, fcu, fcv, size, size)
        _, sample_ok, uu, vv = window_samples(None, size, size, u_min, v_min, u_max, v_max,
                                              stride, KMAX_N_OCCLUSION_STRIDES + 1)
        min_rendered = occlusion.window_min_depth(occ, uu, vv, sample_ok)
        threshold = cfg.modeled_occlusion_threshold
        if cfg.use_depth_scaling:
            threshold = threshold * z
        min_allowed = z - points.modeled_depth_offset - threshold
        occl_ok = occl_ok & ((min_rendered > min_allowed) | ~occ.body_visible[:, None])

    # --- FindCorrespondence (cpp:826-884) ---------------------------------------------
    cd, diameter = correspondence_diameter(cfg, considered_distance, z, z_safe, fu)
    u_min, v_min, u_max, v_max, stride = window_bounds(diameter, k_max, cu, cv,
                                                        width, height)
    min_depth_value = torch.clamp(div_value(z - cd, depth_scale), max=0.0)
    max_depth_value = div_value(z + cd, depth_scale)

    n_samples = k_max + 1
    d, sample_ok, uu, vv = window_samples(
        None if presampled is not None else depth_image, width, height,
        u_min, v_min, u_max, v_max, stride, n_samples)
    if presampled is not None:
        d, in_crop = presampled
        sample_ok = sample_ok & in_crop
    in_range = ((d > min_depth_value[..., None, None])
                & (d < max_depth_value[..., None, None]))
    ok = sample_ok & in_range

    d_m = d * depth_scale
    px = div_value((uu[..., None, :].to(torch.float32) - ppu) * d_m, fu)
    py = div_value((vv[..., :, None].to(torch.float32) - ppv) * d_m, fv)
    dx = px - c[..., 0, None, None]
    dy = py - c[..., 1, None, None]
    dz = d_m - c[..., 2, None, None]
    dist2 = dx * dx + dy * dy + dz * dz
    dist2 = torch.where(ok, dist2, torch.full_like(dist2, float("inf")))
    flat = dist2.reshape(n_bodies, n_pts, n_samples * n_samples)
    best = torch.argmin(flat, dim=-1, keepdim=True)   # first minimum, as jnp.argmin

    def pick(x):
        return torch.gather(x.reshape(n_bodies, n_pts, -1), 2, best)[..., 0]

    found = pick(flat) < cd * cd
    correspondence = torch.stack([pick(px), pick(py), pick(d_m)], dim=-1)

    # Two-pass occlusion fallback (cpp:295-313).
    valid_with = valid & occl_ok & found
    n_with = valid_with.sum(dim=-1, keepdim=True)
    use_occl = handle_occlusions[:, None] & (n_with >= cfg.min_n_unoccluded_points)
    final_valid = torch.where(use_occl, valid_with, valid & found)

    return DepthDataPoints(
        center_f_body=points.center_f_body,
        normal_f_body=points.normal_f_body,
        correspondence_center_f_camera=correspondence,
        valid=final_valid,
    )


def calculate_gradient_and_hessian(points: DepthDataPoints, body2camera_pose,
                                   standard_deviation: float):
    """Point-to-plane Gauss-Newton terms in body frame (cpp:333-381):
    ((B, 6), (B, 6, 6))."""
    pose = body2camera_pose
    rot = pose[:, :3, :3]
    camera2body_t = -(rot.transpose(1, 2) @ pose[:, :3, 3, None])[..., 0]
    corr = points.correspondence_center_f_camera
    corr_body = corr @ rot + camera2body_t[:, None, :]

    n = points.normal_f_body
    eps = torch.sum(n * (points.center_f_body - corr_body), dim=-1)
    cross = torch.linalg.cross(corr_body, n, dim=-1)

    corr_depth = corr[..., 2]
    depth_safe = torch.where(corr_depth != 0, corr_depth, torch.ones_like(corr_depth))
    weight = rdiv(1.0, standard_deviation * depth_safe)
    w2 = weight * weight
    wmask = torch.where(points.valid, w2, torch.zeros_like(w2))

    grad_rot = -torch.sum((wmask * eps)[..., None] * cross, dim=1)
    grad_trans = -torch.sum((wmask * eps)[..., None] * n, dim=1)
    gradient = torch.cat([grad_rot, grad_trans], dim=-1)

    stacked = torch.cat([cross, n], dim=-1)                         # (B, P, 6)
    hessian = -((stacked * wmask[..., None]).transpose(1, 2) @ stacked)
    return gradient, hessian
