"""Texture-modality terms: Tukey-weighted reprojection Gauss-Newton (port of
m3t_tpu/ops/texture_fn.py).

Feature detection, description and matching run on the host; the matched 3D-2D
correspondences arrive as fixed-shape masked arrays, whose gradient and Hessian are
computed on the device for a batch of bodies (TextureModality::
CalculateGradientAndHessian, texture_modality.cpp:397-444).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from m3t_tpu_torch.ops.depth_fn import rdiv


class TexturePoints(NamedTuple):
    """Matched keypoint correspondences for a batch of bodies (host-extracted)."""

    center_f_body: torch.Tensor  # (B, K, 3) keyframe 3D points in the body frame
    image_uv: torch.Tensor  # (B, K, 2) matched keypoint locations in the current image
    valid: torch.Tensor  # (B, K) bool (K is a static padding size)


def calculate_gradient_and_hessian(points: TexturePoints, pose, fu: float, fv: float,
                                   ppu: float, ppv: float, standard_deviation: float,
                                   tukey_norm_constant: float = 20.0):
    """Per-body Tukey-weighted reprojection terms for (B, 4, 4) poses:
    ((B, 6), (B, 6, 6))."""
    p = points.center_f_body
    rot = pose[:, :3, :3]
    c = p @ rot.transpose(1, 2) + pose[:, None, :3, 3]
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    z_ok = z > 1e-6
    z = torch.where(z_ok, z, torch.ones_like(z))
    proj = torch.stack([x * fu / z + ppu, y * fv / z + ppv], dim=-1)
    diff = proj - points.image_uv
    squared_error = torch.sum(diff * diff, dim=-1)
    error = torch.sqrt(squared_error)

    k = tukey_norm_constant
    inside = torch.abs(error) <= k
    r = error / k
    u = 1.0 - r * r
    tukey = torch.where(inside, (k * k / 6.0) * (1.0 - u * u * u),
                        torch.full_like(error, k * k / 6.0))
    variance = standard_deviation * standard_deviation
    weight = torch.where(error > 1e-30, tukey / torch.clamp(squared_error, min=1e-30),
                         torch.ones_like(error)) / variance
    weight = torch.where(z_ok & points.valid, weight, torch.zeros_like(weight))

    z2 = z * z
    zeros = torch.zeros_like(z)
    dx_dX = torch.stack([
        torch.stack([rdiv(fu, z), zeros, -x * fu / z2], dim=-1),
        torch.stack([zeros, rdiv(fv, z), -y * fv / z2], dim=-1),
    ], dim=-2)                                              # (B, K, 2, 3)
    dx_dt = dx_dX @ rot[:, None]                            # (B, K, 2, 3)
    px, py, pz = p[..., 0], p[..., 1], p[..., 2]
    skews = torch.stack([
        torch.stack([zeros, -pz, py], dim=-1),
        torch.stack([pz, zeros, -px], dim=-1),
        torch.stack([-py, px, zeros], dim=-1),
    ], dim=-2)                                              # (B, K, 3, 3)
    dx_dtheta = torch.cat([-(dx_dt @ skews), dx_dt], dim=-1)  # (B, K, 2, 6)

    gradient = -torch.einsum("bn,bnk,bnkj->bj", weight, diff, dx_dtheta)
    hessian = -torch.einsum("bn,bnki,bnkj->bij", weight, dx_dtheta, dx_dtheta)
    return gradient, hessian
